"""Whisper medium — encoder-decoder speech model; conv/mel frontend stubbed.

[arXiv:2212.04356] 24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.
``input_specs`` supplies precomputed frame embeddings (B, 1500, d_model)
in place of the mel-spectrogram + conv feature extractor (per brief).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    source="arXiv:2212.04356",
    num_layers=24,           # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    is_encoder_decoder=True,
    encoder_seq_len=1500,
    frontend="audio_stub",
    tie_embeddings=True,
)

TINY = CONFIG.replace(
    name="whisper-medium-tiny",
    num_layers=2,
    encoder_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    encoder_seq_len=64,
)
