"""Plain PyTorch version of single-token GQA decode attention.

Counterpart of ``repro.kernels.decode_attention.ref.decode_attention_ref``.
``pos`` may be a Python int or a device tensor; it is never read back to
the host.
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
