"""Qwen3-MoE 30B-A3B — 128-expert top-8 fine-grained MoE.

[hf:Qwen/Qwen3-30B-A3B] 48L d_model=2048 32H (GQA kv=4) d_ff=768/expert
vocab=151936, MoE 128 experts top-8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,                # per-expert hidden
    vocab_size=151936,
    num_experts=128,
    num_experts_per_tok=8,
    moe_d_ff=768,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

TINY = CONFIG.replace(
    name="qwen3-moe-30b-a3b-tiny",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=64,
    moe_d_ff=64,
    vocab_size=512,
    num_experts=4,
    num_experts_per_tok=2,
)
