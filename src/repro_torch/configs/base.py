"""Model / run configuration system.

Every assigned architecture gets one file in this package exporting a
``CONFIG`` (full-scale, exercised only via the dry-run) and a ``TINY``
(reduced same-family variant: <=2 layers, d_model<=512, <=4 experts) used by
smoke tests, examples, and real-execution benchmarks.
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional, Sequence


# ---------------------------------------------------------------------------
# Block kinds used by the layer pattern machinery.  A model is a sequence of
# "groups"; each group is (kind, count) and is executed with lax.scan over its
# stacked parameters so that 80-layer models keep a compact HLO.
# ---------------------------------------------------------------------------
ATTN = "attn"          # full causal self-attention + MLP (or MoE) block
SWA = "swa"            # sliding-window causal attention + MLP/MoE block
MAMBA = "mamba"        # Mamba2 SSD block
SHARED_ATTN = "shared_attn"  # zamba-style shared (tied) attention block
ENC_ATTN = "enc_attn"  # bidirectional encoder self-attention block
DEC_ATTN = "dec_attn"  # decoder block with self- and cross-attention


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | audio | vlm
    source: str                         # citation: arXiv id / model card
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None      # default d_model // num_heads

    # --- attention variants -------------------------------------------------
    attention_bias: bool = False        # qwen2: bias on QKV projections
    attn_logit_softcap: Optional[float] = None   # gemma2: 50.0
    final_logit_softcap: Optional[float] = None  # gemma2: 30.0
    sliding_window: Optional[int] = None         # SWA width (mixtral/gemma2 local)
    local_global_alternating: bool = False       # gemma2: L,G,L,G,...
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    post_block_norm: bool = False       # gemma2 uses pre+post norms
    scale_embeddings: bool = False      # gemma2 multiplies embeds by sqrt(d)
    tie_embeddings: bool = True

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: Optional[int] = None      # expert hidden size (d_ff used if None)
    router_aux_loss_coef: float = 0.01

    # --- SSM (Mamba2 / SSD) -------------------------------------------------
    ssm_state_size: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk_size: int = 256

    # --- hybrid (zamba2) ----------------------------------------------------
    hybrid_attn_every: int = 0          # insert one shared attn block every k mamba blocks

    # --- encoder-decoder (whisper) ------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 0            # frames after the (stubbed) conv frontend

    # --- modality frontend stubs --------------------------------------------
    frontend: Optional[str] = None      # 'audio_stub' | 'vision_stub'
    num_frontend_tokens: int = 0        # patch/frame embeddings prepended (vlm)

    # --- numerics / kernels ---------------------------------------------------
    kernel_impl: str = "xla"    # 'xla' | 'pallas' (Pallas TPU kernels; on CPU
                                # they run in interpret mode — inference paths
                                # only, training always uses the custom-VJP XLA
                                # flash implementation)
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    # -- derived -------------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if decode at 500k tokens is sub-quadratic / memory-bounded.

        SSM and hybrid archs carry O(1) state; archs with a sliding window
        (everywhere or on alternating local layers) keep bounded live cache on
        those layers.  Pure full-attention archs return False and long_500k is
        skipped for them (recorded in DESIGN.md / EXPERIMENTS.md).
        """
        if self.arch_type in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    @property
    def layer_groups(self) -> Sequence[tuple]:
        """Sequence of (kind, count) groups executed in order.

        Homogeneous groups are scanned; heterogeneous patterns are expressed as
        repeated super-blocks (e.g. gemma2's (local, global) pair scanned 13x).
        """
        if self.arch_type == "ssm":
            return ((MAMBA, self.num_layers),)
        if self.arch_type == "hybrid":
            # zamba2: repeating super-block of k mamba + 1 shared attention.
            k = self.hybrid_attn_every
            n_super = self.num_layers // (k + 1)
            rem = self.num_layers - n_super * (k + 1)
            groups = [("hybrid_super", n_super)]
            if rem:
                groups.append((MAMBA, rem))
            return tuple(groups)
        if self.is_encoder_decoder:
            return ((ENC_ATTN, self.encoder_layers), (DEC_ATTN, self.num_layers))
        if self.local_global_alternating:
            assert self.num_layers % 2 == 0
            return (("local_global", self.num_layers // 2),)
        kind = SWA if self.sliding_window is not None else ATTN
        return ((kind, self.num_layers),)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, h, kv, hd, ff, v = (self.d_model, self.num_heads, self.num_kv_heads,
                               self.head_dim, self.d_ff, self.vocab_size)
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.attention_bias:
            attn += (h + 2 * kv) * hd
        mlp = 3 * d * ff  # gate/up/down
        if self.num_experts:
            eff = self.moe_d_ff or ff
            mlp = self.num_experts * 3 * d * eff + d * self.num_experts  # + router
        norm = 2 * d * (2 if self.post_block_norm else 1)

        def mamba_block_params() -> int:
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_head_dim
            # in_proj -> [z, x, B, C, dt], conv, A/D/dt_bias, out_proj, norm
            zxbcdt = d * (2 * d_in + 2 * self.ssm_state_size + nheads)
            conv = (d_in + 2 * self.ssm_state_size) * self.ssm_conv_width
            extra = 3 * nheads + d_in  # A_log, D, dt_bias, gated-norm weight
            out = d_in * d
            return zxbcdt + conv + extra + out + d

        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        for kind, count in self.layer_groups:
            if kind in (ATTN, SWA, ENC_ATTN):
                total += count * (attn + mlp + norm)
            elif kind == DEC_ATTN:
                total += count * (2 * attn + mlp + norm + 2 * d)
            elif kind == MAMBA:
                total += count * mamba_block_params()
            elif kind == "hybrid_super":
                total += count * self.hybrid_attn_every * mamba_block_params()
                total += attn + mlp + norm  # shared (tied) attention block, counted once
            elif kind == "local_global":
                total += count * 2 * (attn + mlp + norm)
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts active)."""
        if not self.num_experts:
            return self.param_count()
        eff = self.moe_d_ff or self.d_ff
        inactive = (self.num_experts - self.num_experts_per_tok) * 3 * self.d_model * eff
        per_layer_inactive = inactive
        n_moe_layers = self.num_layers
        return self.param_count() - n_moe_layers * per_layer_inactive

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes assigned to this paper (public pool).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = (
    "mixtral_8x22b",
    "gemma2_2b",
    "qwen2_72b",
    "whisper_medium",
    "smollm_360m",
    "zamba2_1p2b",
    "granite_20b",
    "mamba2_1p3b",
    "qwen3_moe_30b_a3b",
    "internvl2_2b",
)

# CLI ids (dashes) -> module names
_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIASES.update({
    "mixtral-8x22b": "mixtral_8x22b",
    "gemma2-2b": "gemma2_2b",
    "qwen2-72b": "qwen2_72b",
    "whisper-medium": "whisper_medium",
    "smollm-360m": "smollm_360m",
    "zamba2-1.2b": "zamba2_1p2b",
    "granite-20b": "granite_20b",
    "mamba2-1.3b": "mamba2_1p3b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "internvl2-2b": "internvl2_2b",
})


def get_config(arch: str, tiny: bool = False) -> ModelConfig:
    mod_name = _ALIASES.get(arch, arch.replace("-", "_").replace(".", "p"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.TINY if tiny else mod.CONFIG


def all_configs(tiny: bool = False):
    return {a: get_config(a, tiny=tiny) for a in ARCH_IDS}


# ---------------------------------------------------------------------------
# Port-only: the torch dtype a config's ``dtype`` string names.
# ---------------------------------------------------------------------------
def torch_dtype(cfg: ModelConfig):
    import torch
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[cfg.dtype]
