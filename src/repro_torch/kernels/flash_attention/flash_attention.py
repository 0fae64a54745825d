"""Hopper flash-attention forward: launcher for ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/
flash_attention.py::flash_attention_fwd``.  The CUDA source's header says
what bounds it on the card and what its design does about that.  Three
bodies, chosen in C by dtype, head_dim, the operands' 16-byte alignment and
their strides:

  * ``wgmma`` (bf16, head_dim 64, 128 or 256): TMA loads of K/V tiles into
    a ring of shared-memory stages, ``wgmma`` for QK^T and PV, one block
    per (query tile, query head, batch); its tile (``block_q`` x
    ``block_k``, ``TILES`` by head_dim) is a knob.  At head_dim 256 a
    block's shared memory is 164,904 B at (64, 64) and 197,672 B at (128,
    64), one block an SM, and a 128-key tile does not fit; bounded by the
    bytes it moves.  At Gemma-2's prefill call (8 x 512, 8 heads, 4 kv
    heads, cap 50) 0.051 ms on the device at (64, 64), 0.045 at (128, 64),
    against a 0.0150 ms bound and SDPA's 0.038 (H100 80GB HBM3, 700 W);
  * ``mma_sync`` (bf16 at the other head sizes that are multiples of 16 up
    to 128): ``mma.sync`` m16n8k16, the GQA group folded into the rows;
  * ``cuda_cores`` (float32 at any head_dim up to 256, and views the
    tensor-core bodies cannot read): float32 FMAs, the group folded into
    the rows; at head_dim 256 198,912 B of shared memory a block, 1.62 ms
    at Gemma-2's call in bf16.

The last two have one tile each: ``fixed_tile(G)``.  Takes the model's
(B, T, H, hd) / (B, T, KV, hd) layout directly through strides: no
transpose, no padding.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

LAUNCHES = 0          # launches of the CUDA kernel since the last reset
BODIES = ("cuda_cores", "mma_sync", "wgmma")      # by the C function's code
LAUNCHES_BY_BODY = dict.fromkeys(BODIES, 0)       # the same launches, by body

# the wgmma body's constants, which the autotuner prices its tiles by
# without a built library; ``_lib`` holds them against the C library's
# ``flash_wgmma_config`` and raises where they differ
# (block_q, block_k) of the wgmma body by head_dim: 64 or 128 each, and at
# head_dim 256 64-key tiles only (a 128-key tile overflows shared memory)
TILES = {64: ((64, 64), (64, 128), (128, 64), (128, 128)),
         128: ((64, 64), (64, 128), (128, 64), (128, 128)),
         256: ((64, 64), (128, 64))}
DEFAULT_TILE = (64, 64)   # the wgmma body's tile when none is given
STAGES = 2            # K/V tiles in flight in the wgmma body

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fixed_tile(G: int) -> tuple:
    """(block_q, block_k) of the mma_sync and cuda_cores bodies: 64 rows of
    query positions times the G heads of a group, by 64 keys."""
    return max(64 // G, 1), 64


def wgmma_class(dtype, hd: int) -> bool:
    """Whether the wgmma body takes this dtype and head_dim (given aligned
    operands)."""
    return str(dtype).replace("torch.", "") == "bfloat16" and hd in TILES


def wgmma_smem(hd: int, block_q: int, block_k: int) -> int:
    """Shared memory of a wgmma block: 1 KB of alignment slack, the bf16 Q
    tile and ``STAGES`` K and V tiles, and the 2 ``STAGES`` + 1
    mbarriers."""
    return 1024 + 2 * hd * (block_q + 2 * STAGES * block_k) + 8 * (
        2 * STAGES + 1)


def reset_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for name in BODIES:
        LAUNCHES_BY_BODY[name] = 0


def _lib():
    lib = build.library("flash_attention")
    if not getattr(lib, "_typed", False):
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd.argtypes = [
            P, P, P, P, I, I, I, I, I, I, I, P, I, I, F, I, F, I, I, I,
            ctypes.POINTER(I), P]
        lib.flash_attention_fwd.restype = I
        lib.flash_wgmma_config.argtypes = [I, P, P, P, P]
        lib.flash_wgmma_config.restype = None
        _check_config(lib)
        lib._typed = True
    return lib


def _check_config(lib) -> None:
    """Raise unless the C library's wgmma constants are this module's."""
    cap = 32
    inst, default = (ctypes.c_int * (4 * cap))(), (ctypes.c_int * 2)()
    n, stages = ctypes.c_int(), ctypes.c_int()
    lib.flash_wgmma_config(cap, ctypes.byref(n), inst, default,
                           ctypes.byref(stages))
    got = (tuple(default), stages.value, n.value,
           [tuple(inst[4 * i:4 * i + 4]) for i in range(min(n.value, cap))])
    rows = [(hd, bq, bk, wgmma_smem(hd, bq, bk))
            for hd, tiles in TILES.items() for bq, bk in tiles]
    want = (DEFAULT_TILE, STAGES, len(rows), rows)
    if got != want:
        raise RuntimeError(f"flash_attention: the library's wgmma constants "
                           f"(default tile, stages, tiles, (head_dim, "
                           f"block_q, block_k, shared memory) a tile) {got} "
                           f"differ from the launcher's {want}")


def flash_attention_fwd(
    q: torch.Tensor,        # (B, Tq, H, hd), CUDA, last dim contiguous
    k: torch.Tensor,        # (B, Tk, KV, hd)
    v: torch.Tensor,        # (B, Tk, KV, hd)
    *,
    causal: bool,
    window: Optional[int],
    logit_cap: Optional[float],
    q_offset: int = 0,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    tuned: int = 0,
) -> torch.Tensor:
    """``block_q`` / ``block_k`` None take the body's default tile; a tile
    the body lacks raises without a launch.  ``tuned``: bit 0 / bit 1 where
    ``block_q`` / ``block_k`` came from the autotune cache, a wgmma tile
    that the other bodies replace by their own."""
    global LAUNCHES
    B, Tq, H, hd = q.shape
    _, Tk, KV, _ = k.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    body = ctypes.c_int(-1)
    err = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPES[q.dtype], B, Tq, Tk, KV, H // KV, hd, strides, int(causal),
        window or 0, float(logit_cap or 0.0), q_offset, float(hd ** -0.5),
        block_q or 0, block_k or 0, tuned, ctypes.byref(body),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, f"flash_attention_fwd (tile {block_q} x {block_k})")
    LAUNCHES += 1
    LAUNCHES_BY_BODY[BODIES[body.value]] += 1
    return o
