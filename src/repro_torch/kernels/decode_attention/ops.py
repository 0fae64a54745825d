"""Public wrappers of the decode-attention kernel.

``decode_attention`` takes the (B, S, KV, hd) cache layout and
``decode_attention_kvmajor`` the model's (B, KV, S, hd) layout; both reach
the same kernel through strides, without a transpose.  A CPU tensor goes to
the plain version (``ref.decode_attention_ref``); a CUDA tensor launches
the Hopper kernel.  Anything the kernel does not take raises; nothing falls
back.  ``pos`` may be an int or a device tensor and is never read back.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import decode_attention as _kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def _check(q, k, v, kv_axis: int) -> None:
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, hd = q.shape
    KV = k.shape[kv_axis]
    if k.shape[0] != B or k.shape[3] != hd or H % KV:
        raise ValueError("decode_attention: q and the cache disagree on "
                         "batch, head_dim or GQA grouping")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _kernel._DTYPES:
        raise ValueError(f"decode_attention: dtype {q.dtype}/{k.dtype}/"
                         f"{v.dtype} (float32 or bfloat16, all alike)")
    if hd % 8 or hd > 256:
        raise ValueError(f"decode_attention: head_dim {hd} (multiple of 8, "
                         "at most 256)")
    if not q.is_contiguous() or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("decode_attention: q must be contiguous and the "
                         "cache's last dim contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError("decode_attention: tensors on different devices")


def _pos_on_device(pos, device) -> torch.Tensor:
    return torch.as_tensor(pos, device=device).reshape(1).to(torch.int32)


def _launch(q, k_kvmajor, v_kvmajor, pos, window, logit_cap):
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    return _kernel.decode_attention_fwd(
        q, k_kvmajor, v_kvmajor, _pos_on_device(pos, q.device),
        window=window, logit_cap=logit_cap)


def decode_attention(
    q: torch.Tensor,        # (B, H, hd)
    k_cache: torch.Tensor,  # (B, S, KV, hd)
    v_cache: torch.Tensor,  # (B, S, KV, hd)
    pos,                    # scalar: cache valid on [0, pos]
    *,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
) -> torch.Tensor:
    _check(q, k_cache, v_cache, kv_axis=2)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, pos, window=window,
                                    logit_cap=logit_cap)
    return _launch(q, k_cache.transpose(1, 2), v_cache.transpose(1, 2), pos,
                   window, logit_cap)


def decode_attention_kvmajor(
    q: torch.Tensor,        # (B, H, hd)
    k_cache: torch.Tensor,  # (B, KV, S, hd) — the model's layout
    v_cache: torch.Tensor,
    pos,
    *,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
) -> torch.Tensor:
    _check(q, k_cache, v_cache, kv_axis=1)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache.transpose(1, 2),
                                    v_cache.transpose(1, 2), pos,
                                    window=window, logit_cap=logit_cap)
    return _launch(q, k_cache, v_cache, pos, window, logit_cap)
