"""Mamba2 1.3B — attention-free SSD (state-space duality).

[arXiv:2405.21060] 48L d_model=2048 d_ff=0 vocab=50280, ssm_state=128.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state_size=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    tie_embeddings=True,
)

TINY = CONFIG.replace(
    name="mamba2-1.3b-tiny",
    num_layers=2,
    d_model=128,
    ssm_state_size=16,
    ssm_head_dim=32,
    vocab_size=512,
)
