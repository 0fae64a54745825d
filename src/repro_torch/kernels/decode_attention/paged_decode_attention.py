"""Hopper paged split-K decode attention: launcher for
``csrc/paged_decode_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention/
paged_decode_attention.py::paged_decode_attention_fwd``.  The CUDA source's
header says what bounds it on the card (the bytes of the live keys) and
what its design does about that: the pool is read in place through its
strides, the key axis is split across blocks so that a small batch still
fills the SMs, keys past a slot's length are never read (nor their table
entries), and a second launch merges the splits.  ``kv_lens`` stays on the
device: nothing here synchronises with the host.

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
_BK = 64              # keys per shared-memory tile in the CUDA source
_TARGET_BLOCKS = 264  # two blocks for each of the H100's 132 SMs


def _lib():
    lib = build.library("paged_decode_attention")
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_decode_attention_fwd.argtypes = [
            P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, ctypes.c_longlong,
            P, I, I, I, F, F, P]
        lib.paged_decode_attention_fwd.restype = I
        lib._typed = True
    return lib


def split_plan(BKV: int, ns: int, page_size: int) -> tuple:
    """(split_len, n_split): enough splits that BKV * n_split blocks fill
    the card, each a whole number of pages and, for pages smaller than a
    64-key tile, a whole number of tiles.  Depends on shapes only, never
    on the lengths."""
    tiles = math.ceil(ns * page_size / _BK)
    want = min(tiles, max(1, math.ceil(_TARGET_BLOCKS / BKV)))
    step = max(1, _BK // page_size)           # pages per tile
    pages = math.ceil(math.ceil(ns / want) / step) * step
    return pages * page_size, math.ceil(ns / pages)


def paged_decode_attention_fwd(
    q: torch.Tensor,             # (B, H, hd) contiguous, CUDA
    k_pages: torch.Tensor,       # (P, psz, KV, hd), last dim contiguous
    v_pages: torch.Tensor,
    kv_lens: torch.Tensor,       # (B,) int32 on the device
    block_tables: torch.Tensor,  # (B, ns) int32 on the device, last dim contiguous
    *,
    window: Optional[int],
    logit_cap: Optional[float],
) -> torch.Tensor:
    global LAUNCHES
    B, H, hd = q.shape
    _, psz, KV, _ = k_pages.shape
    G = H // KV
    ns = block_tables.shape[1]
    split_len, n_split = split_plan(B * KV, ns, psz)
    f32 = dict(dtype=torch.float32, device=q.device)
    part_m = torch.empty((B * KV, n_split, G), **f32)
    part_l = torch.empty((B * KV, n_split, G), **f32)
    part_acc = torch.empty((B * KV, n_split, G, hd), **f32)
    o = torch.empty_like(q)
    strides = (ctypes.c_longlong * 6)(*k_pages.stride()[:3],
                                      *v_pages.stride()[:3])
    err = _lib().paged_decode_attention_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        kv_lens.data_ptr(), block_tables.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(), o.data_ptr(), _DTYPES[q.dtype],
        B, KV, G, hd, psz, ns, block_tables.stride(0), strides, split_len,
        n_split, window or 0, float(logit_cap or 0.0), float(hd ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_decode_attention_fwd")
    LAUNCHES += 1
    return o
