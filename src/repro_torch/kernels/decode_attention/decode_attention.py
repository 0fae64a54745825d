"""Hopper split-K decode attention: launcher for ``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention/
decode_attention.py::decode_attention_fwd``.  The CUDA source's header says
what bounds it on the card (the bytes of the live cache) and what its design
does about that: the key axis is split across blocks so that a small batch
still fills the SMs, the G query heads of a kv head share every K/V tile,
tiles past ``pos`` are never read, and a second launch merges the splits.
``pos`` stays on the device: nothing here synchronises with the host.

One call launches two CUDA kernels (the split pass and the merge);
``LAUNCHES`` counts calls.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

LAUNCHES = 0          # calls that launched the kernel pair since the last reset

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BK = 64              # keys per tile in the CUDA source
_TARGET_BLOCKS = 264  # two blocks for each of the H100's 132 SMs


def _lib():
    lib = build.library("decode_attention")
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.decode_attention_fwd.argtypes = [
            P, P, P, P, P, P, P, P, I, I, I, I, I, I, P, I, I, I, F, F, P]
        lib.decode_attention_fwd.restype = I
        lib._typed = True
    return lib


def split_plan(BKV: int, S: int) -> tuple:
    """(split_len, n_split): enough splits that BKV * n_split blocks fill the
    card, each a whole number of 64-key tiles.  Depends on shapes only, so
    a step's launches never change with ``pos``."""
    tiles = math.ceil(S / _BK)
    want = min(tiles, max(1, math.ceil(_TARGET_BLOCKS / BKV)))
    split_len = math.ceil(tiles / want) * _BK
    return split_len, math.ceil(S / split_len)


def decode_attention_fwd(
    q: torch.Tensor,        # (B, H, hd) contiguous, CUDA
    k: torch.Tensor,        # (B, KV, S, hd) or any strides over (B, KV, S)
    v: torch.Tensor,
    pos: torch.Tensor,      # (1,) int32 on the device
    *,
    window: Optional[int],
    logit_cap: Optional[float],
    split_len: Optional[int] = None,
) -> torch.Tensor:
    """k/v are indexed [b, kv_head, slot, :]; pass a permuted view for the
    (B, S, KV, hd) layout.  ``split_len`` (keys per split, a multiple of
    64) defaults to ``split_plan``'s."""
    global LAUNCHES
    B, H, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    if split_len is None:
        split_len, n_split = split_plan(B * KV, S)
    else:
        n_split = math.ceil(S / split_len)
    f32 = dict(dtype=torch.float32, device=q.device)
    part_m = torch.empty((B * KV, n_split, G), **f32)
    part_l = torch.empty((B * KV, n_split, G), **f32)
    part_acc = torch.empty((B * KV, n_split, G, hd), **f32)
    o = torch.empty_like(q)
    strides = (ctypes.c_longlong * 6)(*k.stride()[:3], *v.stride()[:3])
    err = _lib().decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        o.data_ptr(), _DTYPES[q.dtype], B, KV, G, S, hd, strides, split_len,
        n_split, window or 0, float(logit_cap or 0.0), float(hd ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "decode_attention_fwd")
    LAUNCHES += 1
    return o
