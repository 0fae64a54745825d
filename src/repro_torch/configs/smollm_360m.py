"""SmolLM 360M — small llama-arch dense model.

[hf:HuggingFaceTB/SmolLM-135M family] 32L d_model=960 15H (GQA kv=5)
d_ff=2560 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    arch_type="dense",
    source="hf:HuggingFaceTB/SmolLM-135M",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
)

TINY = CONFIG.replace(
    name="smollm-360m-tiny",
    num_layers=2,
    d_model=120,
    num_heads=3,
    num_kv_heads=1,
    head_dim=40,
    d_ff=256,
    vocab_size=512,
)
