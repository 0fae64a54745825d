"""Plain PyTorch version of the flash-attention kernel (naive full matrix).

Counterpart of ``repro.kernels.flash_attention.ref.attention_ref``: the
whole (Tq, Tk) score matrix in float32, one softmax, output in q's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def attention_ref(
    q: torch.Tensor,             # (B, Tq, H, hd)
    k: torch.Tensor,             # (B, Tk, KV, hd)
    v: torch.Tensor,             # (B, Tk, KV, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    B, Tq, H, hd = q.shape
    _, Tk, KV, _ = k.shape
    G = H // KV
    scale = hd ** -0.5
    qh = q.reshape(B, Tq, KV, G, hd).float() * scale
    s = torch.einsum("bqkgd,bskd->bkgqs", qh, k.float())
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    qpos = q_offset + torch.arange(Tq, device=q.device)
    kpos = torch.arange(Tk, device=q.device)
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Tq, H, hd).to(q.dtype)
