"""Hopper paged split-K decode attention: launcher for
``csrc/paged_decode_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention/
paged_decode_attention.py::paged_decode_attention_fwd``.  The CUDA source's
header says what bounds it on the card (the bytes of the live keys) and
what its design does about that: the pool is read in place through its
strides and the block table, the key axis is split across the blocks of a
thread-block cluster, each block reads its split's table entries once and
streams its keys through a ring of cp.async tiles with lane groups scoring
one key each, and the cluster's blocks merge the splits through distributed
shared memory.  Keys past a slot's length are never read, nor their table
entries.  One call is ONE CUDA launch and allocates nothing but the output.
``kv_lens`` stays on the device: nothing here synchronises with the host.
``LAUNCHES`` counts calls.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
# the same lane groups and query-row chunks as the split-K kernel's
from repro_torch.kernels.decode_attention.decode_attention import (group_rows,
                                                                  tile_keys)

LAUNCHES = 0          # launches of the CUDA kernel since the last reset

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BK = 64              # keys per 64-key tile; the ring's tiles divide it
_TARGET_BLOCKS = 264  # two blocks for each of the H100's 132 SMs
# the CUDA source's constants; ``_lib`` holds them against the library's
# ``paged_decode_attention_config`` and raises where they differ
MAX_CLUSTER = 16      # splits of one (slot, kv head) one cluster holds
NSTAGE = 4            # K/V tiles in each block's shared-memory ring
GMAX = 8              # query rows one block holds (a chunk of the G group)
TABLE_PAGES = 256     # table entries a block holds: the pages of one split


def _lib():
    lib = build.library("paged_decode_attention")
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_decode_attention_fwd.argtypes = [
            P, P, P, P, P, P, I, I, I, I, I, I, I, ctypes.c_longlong, P, I, I,
            I, F, F, P]
        lib.paged_decode_attention_fwd.restype = I
        got = (ctypes.c_int * 4)()
        lib.paged_decode_attention_config(got)
        want = (MAX_CLUSTER, NSTAGE, GMAX, TABLE_PAGES)
        if tuple(got) != want:
            raise RuntimeError(f"paged_decode_attention: the library's "
                               f"constants {tuple(got)} are not the "
                               f"launcher's {want}")
        lib._typed = True
    return lib


def split_plan(BKV: int, ns: int, page_size: int) -> tuple:
    """(split_len, n_split): enough splits that BKV * n_split blocks fill
    the card, never more than one cluster holds (``MAX_CLUSTER``), each a
    whole number of pages, for pages smaller than a 64-key tile a whole
    number of tiles, and at most ``TABLE_PAGES`` pages (a longer table
    gives more splits, which the cluster's blocks walk in turn).  Depends
    on shapes only, never on the lengths."""
    tiles = math.ceil(ns * page_size / _BK)
    want = min(tiles, MAX_CLUSTER, max(1, math.ceil(_TARGET_BLOCKS / BKV)))
    step = max(1, _BK // page_size)           # pages per 64-key tile
    cap = TABLE_PAGES // step * step          # pages a block's table holds
    pages = min(math.ceil(math.ceil(ns / want) / step) * step, cap)
    return pages * page_size, math.ceil(ns / pages)


def smem_bytes(size: int, hd: int, G: int) -> int:
    """Shared memory of one block: the ring of ``NSTAGE`` K/V tiles in the
    pool's dtype, the scaled query rows, the block's (m, l, acc) and the
    split's table entries."""
    gb = group_rows(G)
    return (NSTAGE * 2 * tile_keys(size, hd) * hd * size
            + 4 * (2 * gb * hd + 2 * gb) + 4 * TABLE_PAGES)


def blocks(BKV: int, G: int, n_split: int) -> int:
    """Blocks of one launch: a cluster of min(n_split, ``MAX_CLUSTER``) per
    (slot, kv head) and chunk of the group."""
    gb = group_rows(G)
    return BKV * min(n_split, MAX_CLUSTER) * math.ceil(G / gb)


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
    o = torch.empty_like(q)
    strides = (ctypes.c_longlong * 6)(*k_pages.stride()[:3],
                                      *v_pages.stride()[:3])
    err = _lib().paged_decode_attention_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        kv_lens.data_ptr(), block_tables.data_ptr(), o.data_ptr(),
        _DTYPES[q.dtype], B, KV, G, hd, psz, ns, block_tables.stride(0),
        strides, split_len, n_split, window or 0, float(logit_cap or 0.0),
        float(hd ** -0.5), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_decode_attention_fwd")
    LAUNCHES += 1
    return o
