"""InternVL2 2B — VLM: InternViT (stubbed) + InternLM2-1.8B language backbone.

[arXiv:2404.16821] 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
``input_specs`` supplies precomputed patch embeddings (B, 256, d_model)
in place of the ViT encoder + MLP projector (per brief).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    arch_type="vlm",
    source="arXiv:2404.16821",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    frontend="vision_stub",
    num_frontend_tokens=256,
    tie_embeddings=True,
)

TINY = CONFIG.replace(
    name="internvl2-2b-tiny",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    num_frontend_tokens=16,
)
