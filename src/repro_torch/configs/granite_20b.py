"""Granite 20B Code — dense llama-arch with MQA (kv=1).

[arXiv:2405.04324] 52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    arch_type="dense",
    source="arXiv:2405.04324",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    tie_embeddings=True,
)

TINY = CONFIG.replace(
    name="granite-20b-tiny",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=1,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
)
