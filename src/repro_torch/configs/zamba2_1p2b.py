"""Zamba2 1.2B — Mamba2 backbone with a shared attention block.

[arXiv:2411.15242] 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64.  The shared transformer block is applied every
``hybrid_attn_every`` mamba blocks with tied parameters (the paper's
per-application LoRA deltas are simplified away; noted in DESIGN.md).
The shared attention uses a sliding window in this config so that
long-context decode stays memory-bounded.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    source="arXiv:2411.15242",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state_size=64,
    ssm_expand=2,
    ssm_head_dim=64,
    hybrid_attn_every=5,     # super-block = 5 mamba + 1 shared attn; 6x6=36 + 2 mamba
    sliding_window=4096,
    tie_embeddings=True,
)

TINY = CONFIG.replace(
    name="zamba2-1.2b-tiny",
    num_layers=6,            # one super-block (5 mamba + shared attn)
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    ssm_state_size=16,
    ssm_head_dim=32,
    hybrid_attn_every=5,
    sliding_window=64,
)
