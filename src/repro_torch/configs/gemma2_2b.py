"""Gemma 2 2B — alternating local/global attention, logit softcaps.

[arXiv:2408.00118] 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    arch_type="dense",
    source="arXiv:2408.00118",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    sliding_window=4096,
    local_global_alternating=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_block_norm=True,
    scale_embeddings=True,
    tie_embeddings=True,
)

TINY = CONFIG.replace(
    name="gemma2-2b-tiny",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    sliding_window=64,
)
