"""Plain PyTorch versions of single-token GQA decode attention.

Counterparts of ``repro.kernels.decode_attention.ref``: the dense version
(cache valid on ``[0, pos]``), the ragged version (one length per slot),
and the paged version of the paged kernel (a page pool read through a
block table).  ``pos`` and the lengths may be host values or device
tensors; they are never read back to the host.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def decode_attention_ref(
    q: torch.Tensor,        # (B, H, hd)
    k_cache: torch.Tensor,  # (B, S, KV, hd)
    v_cache: torch.Tensor,  # (B, S, KV, hd)
    pos,                    # scalar — new token index; cache valid [0, pos]
    *,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
) -> torch.Tensor:
    B, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    G = H // KV
    scale = hd ** -0.5
    qh = q.reshape(B, KV, G, hd).float() * scale
    s = torch.einsum("bkgd,bskd->bkgs", qh, k_cache.float())
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    kpos = torch.arange(S, device=q.device)
    mask = kpos <= pos
    if window is not None:
        mask = mask & (kpos > pos - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, H, hd).to(q.dtype)


def decode_attention_ref_ragged(
    q: torch.Tensor,        # (B, H, hd)
    k_cache: torch.Tensor,  # (B, S, KV, hd)
    v_cache: torch.Tensor,  # (B, S, KV, hd)
    lens,                   # (B,) — valid cache entries per slot: [0, lens)
    *,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
) -> torch.Tensor:
    """Ragged batch: each slot attends over its own cache length.  A slot
    with ``lens[b] == 0`` (freed) returns zeros."""
    B, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    G = H // KV
    scale = hd ** -0.5
    lens = torch.as_tensor(lens, device=q.device).to(torch.int64)
    qh = q.reshape(B, KV, G, hd).float() * scale
    s = torch.einsum("bkgd,bskd->bkgs", qh, k_cache.float())
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    kpos = torch.arange(S, device=q.device)[None, :]           # (1, S)
    mask = kpos < lens[:, None]                                 # (B, S)
    if window is not None:
        mask = mask & (kpos > lens[:, None] - 1 - window)
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    out = torch.where(lens[:, None, None, None] > 0, out, torch.zeros_like(out))
    return out.reshape(B, H, hd).to(q.dtype)


def paged_decode_attention_ref(
    q: torch.Tensor,        # (B, H, hd)
    k_pages: torch.Tensor,  # (P, psz, KV, hd) — shared page pool
    v_pages: torch.Tensor,
    kv_lens,                # (B,) — valid cache length per slot
    block_tables,           # (B, ns) — physical page per slot and page
    *,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the paged kernel: gather each slot's pages through
    its block table into a dense cache, then the ragged reference.  Table
    entries past a slot's page count are clamped to page 0 first, as the
    reference wrapper does, so they may hold anything."""
    B = q.shape[0]
    _, psz, KV, hd = k_pages.shape
    lens = torch.as_tensor(kv_lens, device=q.device).to(torch.int64)
    tbl = torch.as_tensor(block_tables, device=q.device).to(torch.int64)
    ns = tbl.shape[1]
    used = torch.arange(ns, device=q.device)[None, :] < ((lens + psz - 1)
                                                         // psz)[:, None]
    tbl = torch.where(used, tbl, torch.zeros_like(tbl))
    k = k_pages[tbl].reshape(B, ns * psz, KV, hd)
    v = v_pages[tbl].reshape(B, ns * psz, KV, hd)
    return decode_attention_ref_ragged(q, k, v, lens, window=window,
                                       logit_cap=logit_cap)
