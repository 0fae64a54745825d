"""Hopper split-K decode attention: launcher for ``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention/
decode_attention.py::decode_attention_fwd``.  The CUDA source's header says
what bounds it on the card (the bytes of the live cache) and what its design
does about that: the key axis is split across the blocks of a thread-block
cluster, each block streams its keys through a ring of cp.async tiles with
lane groups scoring one key each, and the cluster's blocks merge the
splits through distributed shared memory.  One call is ONE CUDA launch and
allocates nothing but the output.  ``pos`` stays on the device: nothing here
synchronises with the host.  ``LAUNCHES`` counts calls.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

LAUNCHES = 0          # launches of the CUDA kernel since the last reset

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BK = 64              # split_len is a multiple of this many keys
_TARGET_BLOCKS = 264  # two blocks for each of the H100's 132 SMs
# the CUDA source's constants; ``_lib`` holds them against the library's
# ``decode_attention_config`` and raises where they differ
MAX_CLUSTER = 16      # splits of one (batch, kv head) one cluster holds
NSTAGE = 4            # K/V tiles in each block's shared-memory ring
GMAX = 8              # query rows one block holds (a chunk of the G group)


def _lib():
    lib = build.library("decode_attention")
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.decode_attention_fwd.argtypes = [
            P, P, P, P, P, I, I, I, I, I, I, P, I, I, I, F, F, P]
        lib.decode_attention_fwd.restype = I
        got = (ctypes.c_int * 3)()
        lib.decode_attention_config(got)
        if tuple(got) != (MAX_CLUSTER, NSTAGE, GMAX):
            raise RuntimeError(f"decode_attention: the library's constants "
                               f"{tuple(got)} are not the launcher's "
                               f"{(MAX_CLUSTER, NSTAGE, GMAX)}")
        lib._typed = True
    return lib


def group_rows(G: int) -> int:
    """Query rows a block holds, as the CUDA source instantiates them: the
    group cut into chunks of at most ``GMAX``, rounded up to 1, 2, 3, 4 or
    ``GMAX``."""
    n_chunk = math.ceil(G / GMAX)
    need = math.ceil(G / n_chunk)
    return next(gb for gb in (1, 2, 3, 4, GMAX) if gb >= need)


def tile_keys(size: int, hd: int) -> int:
    """Keys per tile of the ring: a group of LPK lanes (4 to 32) per key,
    each lane VPL 16-byte vectors, as the CUDA source's dispatch picks
    them from the row's 16-byte vectors."""
    nv = hd * size // 16
    lpk = next((n for n in (4, 8, 16, 32) if nv <= n), 32)
    vpl = 2 if nv > 32 else 1
    kps = 32 // lpk
    return 4 * kps * min(4 // vpl, 64 // (4 * kps))


def smem_bytes(size: int, hd: int, G: int) -> int:
    """Shared memory of one block: the ring of ``NSTAGE`` K/V tiles in the
    cache's dtype, the scaled query rows and the block's (m, l, acc)."""
    gb = group_rows(G)
    return NSTAGE * 2 * tile_keys(size, hd) * hd * size + 4 * (
        2 * gb * hd + 2 * gb)


def blocks(BKV: int, G: int, n_split: int) -> int:
    """Blocks of one launch: a cluster of min(n_split, ``MAX_CLUSTER``) per
    (batch, kv head) and chunk of the group."""
    gb = group_rows(G)
    return BKV * min(n_split, MAX_CLUSTER) * math.ceil(G / gb)


def split_plan(BKV: int, S: int) -> tuple:
    """(split_len, n_split): enough splits that BKV * n_split blocks fill the
    card, each a whole number of 64-key tiles, and never more than one
    cluster holds (``MAX_CLUSTER``).  Depends on shapes only, so a step's
    launch never changes with ``pos``."""
    tiles = math.ceil(S / _BK)
    want = min(tiles, MAX_CLUSTER, max(1, math.ceil(_TARGET_BLOCKS / BKV)))
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
    64) defaults to ``split_plan``'s; a split_len that gives more splits
    than a cluster holds has each block walk several in turn."""
    global LAUNCHES
    B, H, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    if split_len is None:
        split_len, n_split = split_plan(B * KV, S)
    else:
        n_split = math.ceil(S / split_len)
    o = torch.empty_like(q)
    strides = (ctypes.c_longlong * 6)(*k.stride()[:3], *v.stride()[:3])
    err = _lib().decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        o.data_ptr(), _DTYPES[q.dtype], B, KV, G, S, hd, strides, split_len,
        n_split, window or 0, float(logit_cap or 0.0), float(hd ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "decode_attention_fwd")
    LAUNCHES += 1
    return o
