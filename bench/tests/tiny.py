"""Cells at a size the CPU holds, built like the benchmark's own: the
same families, traffic kinds and controller, two layers of small widths."""

from bench.spec import Cell

MAMBA = {
    "name": "mamba2_tiny", "family": "mamba2",
    "config": {"d_model": 64, "n_layer": 2, "vocab_size": 256,
               "pad_vocab_size_multiple": 1, "d_state": 16, "d_conv": 4,
               "expand": 2, "headdim": 16, "ngroups": 1, "chunk_size": 16,
               "norm_epsilon": 1e-5, "tie_embeddings": True},
    "port": {"name": "mamba2-tiny", "arch_type": "ssm", "source": "test",
             "num_layers": 2, "d_model": 64, "num_heads": 0,
             "num_kv_heads": 0, "head_dim": 0, "d_ff": 0, "vocab_size": 256,
             "ssm_state_size": 16, "ssm_expand": 2, "ssm_head_dim": 16,
             "ssm_conv_width": 4, "ssm_chunk_size": 16, "norm_eps": 1e-5,
             "tie_embeddings": True, "kernel_impl": "pallas",
             "dtype": "bfloat16"},
    "kernels": ["ssd_scan"],
}
LLAMA = {
    "name": "llama_tiny", "family": "llama",
    "config": {"hidden_size": 64, "intermediate_size": 128,
               "num_attention_heads": 4, "num_key_value_heads": 2,
               "num_hidden_layers": 2, "rms_norm_eps": 1e-5,
               "rope_theta": 10000.0, "vocab_size": 256,
               "tie_word_embeddings": True},
    "port": {"name": "llama-tiny", "arch_type": "dense", "source": "test",
             "num_layers": 2, "d_model": 64, "num_heads": 4,
             "num_kv_heads": 2, "head_dim": 16, "d_ff": 128,
             "vocab_size": 256, "rope_theta": 10000.0, "norm_eps": 1e-5,
             "tie_embeddings": True, "kernel_impl": "pallas",
             "dtype": "bfloat16"},
    "kernels": ["flash_attention", "decode_attention"],
}
# wide enough, and decoding long enough, that the tokens a decode step
# appends to the KV cache move later tokens' logits past the limit
LLAMA_WIDE = {
    "name": "llama_wide", "family": "llama",
    "config": dict(LLAMA["config"], hidden_size=512, intermediate_size=1024,
                   num_attention_heads=8, num_key_value_heads=2,
                   vocab_size=4096),
    "port": dict(LLAMA["port"], name="llama-wide", d_model=512, num_heads=8,
                 num_kv_heads=2, head_dim=64, d_ff=1024, vocab_size=4096),
    "kernels": LLAMA["kernels"],
}
GEN = {"kind": "closed_loop", "prompt_len": 32, "new_tokens": 4,
       "greedy": True, "check_requests": 48}
GEN16 = dict(GEN, new_tokens=16)
SCORE = {"kind": "closed_loop", "prompt_len": 64, "new_tokens": 0,
         "greedy": True, "check_requests": 48}
KNOBS = {"slo_ms": 60000.0,
         "controller": {"name": "dnnscaler", "m": 4, "n": 2, "max_bs": 8,
                        "max_mtl": 2},
         "check": {"widest_gap_limit": 0.05}}


def cell(conf: dict, traffic: dict, limit: float = 0.05) -> Cell:
    knobs = dict(KNOBS, check={"widest_gap_limit": limit})
    return Cell(f"{conf['name']}.tiny", {"chips": 1}, conf, traffic, knobs,
                [], [])
