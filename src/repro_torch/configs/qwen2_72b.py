"""Qwen2 72B — dense GQA with QKV bias.

[arXiv:2407.10671] 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    arch_type="dense",
    source="arXiv:2407.10671",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    attention_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

TINY = CONFIG.replace(
    name="qwen2-72b-tiny",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
)
