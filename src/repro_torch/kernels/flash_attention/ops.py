"""Public wrapper of the flash-attention kernel, in the model's layout.

A CPU tensor goes to the plain version (``ref.attention_ref``); a CUDA
tensor launches the Hopper kernel.  Anything the kernel does not take
(dtype, head_dim, layout, group size, device) raises; nothing falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention as _kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


def _check(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError("flash_attention: q and k/v disagree on batch, "
                         "head_dim or GQA grouping")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _kernel._DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype}/{k.dtype}/"
                         f"{v.dtype} (float32 or bfloat16, all alike)")
    if hd % 8 or hd > 256:
        raise ValueError(f"flash_attention: head_dim {hd} (multiple of 8, "
                         "at most 256)")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: last dim must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: tensors on different devices")


def flash_attention(
    q: torch.Tensor,             # (B, Tq, H, hd)
    k: torch.Tensor,             # (B, Tk, KV, hd)
    v: torch.Tensor,             # (B, Tk, KV, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             logit_cap=logit_cap, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _kernel.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       logit_cap=logit_cap, q_offset=q_offset)
