"""Public wrappers of the decode-attention kernels.

``decode_attention`` takes the (B, S, KV, hd) cache layout and
``decode_attention_kvmajor`` the model's (B, KV, S, hd) layout; both reach
the split-K kernel through strides, without a transpose.
``paged_decode_attention`` serves ragged slots from a shared page pool
through a block table (the token engine's layout) with the paged kernel,
which reads the pool in place.  A CPU tensor goes to the plain version
(``ref``), which takes what the reference's wrapper takes; a CUDA tensor
launches the Hopper kernel, and anything the kernel does not take raises
on it.  Nothing falls back.  ``pos`` and the lengths may be
host values or device tensors and are never read back.

``split_len=None`` consults the autotune cache (``repro_torch.perf.
autotune``) for the best-known split of this shape class, dtype and
device, and takes ``split_plan``'s otherwise: the counterpart of the
reference's ``block_k``.  ``resolve_page_size`` does the same for the page
size of a paged cache.  Explicit keywords win.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import decode_attention as _kernel
from repro_torch.kernels.decode_attention import \
    paged_decode_attention as _paged
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref)
from repro_torch.perf import autotune

DEFAULT_PAGE_SIZE = autotune.DEFAULTS["paged_decode_attention"]["page_size"]


def _check(q, k, v, kv_axis: int, what: str = "decode_attention",
           paged: bool = False) -> None:
    """The shapes and devices every call needs; on a tensor that is not on
    the CPU also the kernel's own limits (dtype, head_dim, layout).  A CPU
    tensor goes to the plain version, which takes what the reference's
    wrapper takes."""
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, hd = q.shape
    KV = k.shape[kv_axis]
    if (not paged and k.shape[0] != B) or k.shape[3] != hd or H % KV:
        raise ValueError(f"{what}: q and the cache disagree on batch, "
                         "head_dim or GQA grouping")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{what}: tensors on different devices")
    if q.device.type == "cpu":
        return
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _kernel._DTYPES:
        raise ValueError(f"{what}: dtype {q.dtype}/{k.dtype}/{v.dtype} "
                         "(float32 or bfloat16, all alike)")
    if hd % 8 or hd > 256:
        raise ValueError(f"{what}: head_dim {hd} (multiple of 8, at most "
                         "256)")
    if not q.is_contiguous() or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError(f"{what}: q must be contiguous and the cache's "
                         "last dim contiguous")


def _resolve_split_len(split_len: Optional[int], q, BKV: int, G: int,
                       S: int) -> Optional[int]:
    """Explicit, else the tuned split for the class, else None
    (``split_plan``'s)."""
    if split_len is None:
        cfg = autotune.lookup("decode_attention", q.dtype, device=q.device,
                              BKV=BKV, G=G, hd=q.shape[2], S=S)
        split_len = cfg["split_len"] if cfg else None
    if split_len is not None and (split_len < _kernel._BK
                                  or split_len % _kernel._BK):
        raise ValueError(f"decode_attention: split_len {split_len} (a "
                         f"positive multiple of {_kernel._BK})")
    return split_len


def _pos_on_device(pos, device) -> torch.Tensor:
    if isinstance(pos, torch.Tensor) and pos.dtype == torch.int32 \
            and pos.device == device and pos.numel() == 1:
        return pos.reshape(1)     # the model's step counter, as a view
    return torch.as_tensor(pos, device=device).reshape(1).to(torch.int32)


def _launch(q, k_kvmajor, v_kvmajor, pos, window, logit_cap, split_len):
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    return _kernel.decode_attention_fwd(
        q, k_kvmajor, v_kvmajor, _pos_on_device(pos, q.device),
        window=window, logit_cap=logit_cap, split_len=split_len)


def decode_attention(
    q: torch.Tensor,        # (B, H, hd)
    k_cache: torch.Tensor,  # (B, S, KV, hd)
    v_cache: torch.Tensor,  # (B, S, KV, hd)
    pos,                    # scalar: cache valid on [0, pos]
    *,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    split_len: Optional[int] = None,
) -> torch.Tensor:
    _check(q, k_cache, v_cache, kv_axis=2)
    B, S, KV, _ = k_cache.shape
    split_len = _resolve_split_len(split_len, q, B * KV, q.shape[1] // KV, S)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, pos, window=window,
                                    logit_cap=logit_cap)
    return _launch(q, k_cache.transpose(1, 2), v_cache.transpose(1, 2), pos,
                   window, logit_cap, split_len)


def decode_attention_kvmajor(
    q: torch.Tensor,        # (B, H, hd)
    k_cache: torch.Tensor,  # (B, KV, S, hd) — the model's layout
    v_cache: torch.Tensor,
    pos,
    *,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    split_len: Optional[int] = None,
) -> torch.Tensor:
    _check(q, k_cache, v_cache, kv_axis=1)
    B, KV, S, _ = k_cache.shape
    split_len = _resolve_split_len(split_len, q, B * KV, q.shape[1] // KV, S)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache.transpose(1, 2),
                                    v_cache.transpose(1, 2), pos,
                                    window=window, logit_cap=logit_cap)
    return _launch(q, k_cache, v_cache, pos, window, logit_cap, split_len)


def resolve_page_size(dtype, *, B: int, H: int, KV: int, hd: int,
                      seq_budget: int, page_size: Optional[int] = None,
                      device=None) -> int:
    """Page size for a paged KV cache serving this geometry on ``device``
    (the card unless given).  The page size is the cache's LAYOUT, so it
    is resolved once, when the cache is built: explicit wins, else the
    autotune cache's best-known page size for the shape class, else
    ``DEFAULT_PAGE_SIZE``."""
    if page_size is not None:
        return page_size
    cfg = autotune.lookup("paged_decode_attention", dtype, device=device,
                          BKV=B * KV, G=H // KV, hd=hd, S=seq_budget)
    return cfg["page_size"] if cfg else DEFAULT_PAGE_SIZE


def paged_decode_attention(
    q: torch.Tensor,            # (B, H, hd): one new token per live slot
    k_pages: torch.Tensor,      # (P, page_size, KV, hd): shared page pool
    v_pages: torch.Tensor,      # (P, page_size, KV, hd)
    kv_lens,                    # (B,) int: valid cache length per slot
    block_tables,               # (B, ns) int: physical page ids per slot
    *,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention over a paged, ragged-batch KV cache.  Slot ``b``
    attends over ``kv_lens[b]`` keys read from pages ``block_tables[b, :]``
    of the pool; table entries past a slot's length are never read, and a
    freed slot (``kv_lens[b] == 0``) returns zeros."""
    _check(q, k_pages, v_pages, kv_axis=2, what="paged_decode_attention",
           paged=True)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, kv_lens,
                                          block_tables, window=window,
                                          logit_cap=logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device "
                         f"{q.device}")
    lens = torch.as_tensor(kv_lens, device=q.device).to(torch.int32)
    tbl = torch.as_tensor(block_tables, device=q.device).to(torch.int32)
    if tuple(lens.shape) != (q.shape[0],) or tbl.ndim != 2 \
            or tbl.shape[0] != q.shape[0]:
        raise ValueError(f"paged_decode_attention: kv_lens "
                         f"{tuple(lens.shape)} and block_tables "
                         f"{tuple(tbl.shape)} for batch {q.shape[0]}")
    return _paged.paged_decode_attention_fwd(
        q, k_pages, v_pages, lens.contiguous(), tbl.contiguous(),
        window=window, logit_cap=logit_cap)
