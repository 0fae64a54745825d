"""Public wrapper of the flash-attention kernel, in the model's layout.

A CPU tensor goes to the plain version (``ref.attention_ref``), which
takes what the reference's wrapper takes, any tile included; a CUDA tensor
launches the Hopper kernel, and anything the kernel does not take (dtype,
head_dim, layout, device, tile) raises on it.  Nothing falls back.

Tiles: explicit ``block_q`` / ``block_k`` keywords win; on a CUDA tensor,
those left None come from the autotune cache (``repro_torch.perf.
autotune``) for this shape class, dtype and card, and else from the body's
default, as the reference's wrapper does.  The wgmma body (bf16, head_dim
64, 128 or 256) takes its tiles at that head_dim (``TILES``: 64 or 128
each, and at head_dim 256 64-key tiles only); the other bodies one tile,
``fixed_tile(G)``.  An explicit tile the kernel lacks raises before any
launch.  A tuned tile is the wgmma body's: a call of a tuned class that
another body takes (a view off the 16-byte rule) runs at that body's own
tile.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention as _kernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.perf import autotune


def _check(q, k, v) -> None:
    """The shapes and devices every call needs; on a tensor that is not on
    the CPU also the kernel's own limits (dtype, head_dim, layout).  A CPU
    tensor goes to the plain version, which takes what the reference's
    wrapper takes."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError("flash_attention: q and k/v disagree on batch, "
                         "head_dim or GQA grouping")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: tensors on different devices")
    if q.device.type == "cpu":
        return
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _kernel._DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype}/{k.dtype}/"
                         f"{v.dtype} (float32 or bfloat16, all alike)")
    if hd % 8 or hd > 256:
        raise ValueError(f"flash_attention: head_dim {hd} (multiple of 8, "
                         "at most 256)")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: last dim must be contiguous")


def check_tile(block_q: Optional[int], block_k: Optional[int], G: int,
               hd: int) -> None:
    """Raise unless the tile (a side left None is free) is one some body of
    the kernel has: a wgmma tile at this head_dim (``TILES``), or the other
    bodies' ``fixed_tile(G)``."""
    tile = (block_q, block_k)

    def fits(want):
        return all(x is None or x == w for x, w in zip(tile, want))

    wgmma = _kernel.TILES.get(hd, ())
    if not (any(fits(t) for t in wgmma) or fits(_kernel.fixed_tile(G))):
        raise ValueError(
            f"flash_attention: tile {block_q} x {block_k} (at head_dim {hd} "
            f"the wgmma tiles {wgmma}, or {_kernel.fixed_tile(G)} at G {G})")


def _resolve_tile(block_q, block_k, q, k, causal: bool) -> tuple:
    """Explicit, else the tuned tile for the class, else None (the body's
    default)."""
    if block_q is None or block_k is None:
        B, Tq, H, hd = q.shape
        KV = k.shape[2]
        cfg = autotune.lookup("flash_attention", q.dtype, device=q.device,
                              BKV=B * KV, G=H // KV, hd=hd, Tq=Tq,
                              Tk=k.shape[1], causal=causal)
        if cfg:
            block_q = cfg["block_q"] if block_q is None else block_q
            block_k = cfg["block_k"] if block_k is None else block_k
    return block_q, block_k


def flash_attention(
    q: torch.Tensor,             # (B, Tq, H, hd)
    k: torch.Tensor,             # (B, Tk, KV, hd)
    v: torch.Tensor,             # (B, Tk, KV, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    q_offset: int = 0,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             logit_cap=logit_cap, q_offset=q_offset)
    check_tile(block_q, block_k, q.shape[2] // k.shape[2], q.shape[3])
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    tuned = (block_q is None) | (block_k is None) << 1   # sides the cache fills
    block_q, block_k = _resolve_tile(block_q, block_k, q, k, causal)
    return _kernel.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       logit_cap=logit_cap, q_offset=q_offset,
                                       block_q=block_q, block_k=block_k,
                                       tuned=tuned)
