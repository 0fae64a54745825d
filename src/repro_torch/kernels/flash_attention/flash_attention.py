"""Hopper flash-attention forward: launcher for ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/
flash_attention.py::flash_attention_fwd``.  The CUDA source's header says
what bounds it on the card and what its design does about that: one block
per (batch x kv head, query tile) with the GQA group folded into the rows,
K/V tiles in shared memory, float32 online softmax, fully masked K tiles
skipped, ragged edges masked in the kernel.  bf16 with head_dim a multiple
of 16 up to 128 runs on the tensor cores (mma.sync); float32 and other
head sizes on the CUDA cores.

Takes the model's (B, T, H, hd) / (B, T, KV, hd) layout directly through
strides: no transpose, no padding.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

LAUNCHES = 0          # launches of the CUDA kernel since the last reset

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.library("flash_attention")
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd.argtypes = [
            P, P, P, P, I, I, I, I, I, I, I, P, I, I, F, I, F, P]
        lib.flash_attention_fwd.restype = I
        lib._typed = True
    return lib


def flash_attention_fwd(
    q: torch.Tensor,        # (B, Tq, H, hd), CUDA, last dim contiguous
    k: torch.Tensor,        # (B, Tk, KV, hd)
    v: torch.Tensor,        # (B, Tk, KV, hd)
    *,
    causal: bool,
    window: Optional[int],
    logit_cap: Optional[float],
    q_offset: int = 0,
) -> torch.Tensor:
    global LAUNCHES
    B, Tq, H, hd = q.shape
    _, Tk, KV, _ = k.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    err = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPES[q.dtype], B, Tq, Tk, KV, H // KV, hd, strides, int(causal),
        window or 0, float(logit_cap or 0.0), q_offset, float(hd ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_fwd")
    LAUNCHES += 1
    return o
