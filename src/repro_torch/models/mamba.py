"""Mamba2 block (SSD — state-space duality, arXiv:2405.21060).

Counterpart of ``repro.models.mamba``: the plain chunked SSD for prefill
(mirrored by the Hopper kernel in ``repro_torch.kernels.ssd_scan``) and a
single-step recurrence for decode.

Layout conventions:
  d_inner = ssm_expand * d_model;  H = d_inner // ssm_head_dim heads
  x_ssm: (B, T, H, P)   P = ssm_head_dim
  B/C:   (B, T, N)      N = ssm_state_size  (single "group", shared across heads)
  state: (B, H, P, N)
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import torch_dtype
from repro_torch.distributed import is_dtensor
from repro_torch.models.layers import (from_local, keep_layout,
                                       local_shards, matmul, rmsnorm)


def dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    return d_in, H, cfg.ssm_head_dim, cfg.ssm_state_size


def init_mamba_block(gen, cfg, prefix: tuple, device) -> dict:
    """Random block parameters stacked on ``prefix`` (e.g. ``(count,)``)."""
    d = cfg.d_model
    d_in, H, P, N = dims(cfg)
    conv_dim = d_in + 2 * N
    dt = torch_dtype(cfg)
    f32 = dict(dtype=torch.float32, device=device)

    def normal(*shape):
        return (torch.randn((*prefix, *shape), generator=gen, device=device)
                * 0.02).to(dt)

    def const(values):
        return values.expand(*prefix, H).clone()

    return {
        "norm": torch.ones((*prefix, d), dtype=dt, device=device),
        # in_proj -> [z (d_in), xBC (conv_dim), dt (H)]
        "in_proj": normal(d, 2 * d_in + 2 * N + H),
        "conv_w": normal(cfg.ssm_conv_width, conv_dim),
        "conv_b": torch.zeros((*prefix, conv_dim), dtype=dt, device=device),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, H, **f32))),
        "D": torch.ones((*prefix, H), **f32),
        "dt_bias": const(torch.log(torch.expm1(torch.full((H,), 1e-2, **f32)))),
        "gate_norm": torch.ones((*prefix, d_in), dtype=dt, device=device),
        "out_proj": normal(d_in, d),
    }


def _split_proj(proj: torch.Tensor, cfg):
    d_in, H, P, N = dims(cfg)
    z = proj[..., :d_in]
    xBC = proj[..., d_in:d_in + d_in + 2 * N]
    dt_raw = proj[..., -H:]
    return z, xBC, dt_raw


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along T.  xBC: (B, T, Cdim); w: (W, Cdim).

    The reference's shifted sum in the model dtype, not ``F.conv1d`` (which
    on the card goes through cuDNN, TF32 for float32 by default).
    Returns (out, new_conv_state) where conv_state holds the last W-1
    inputs."""
    W = w.shape[0]
    T = xBC.shape[1]
    if conv_state is None:
        prev = torch.zeros((xBC.shape[0], W - 1, xBC.shape[-1]),
                           dtype=xBC.dtype, device=xBC.device)
    else:
        prev = conv_state
    xp = torch.cat([prev, xBC], dim=1)                  # (B, T+W-1, C)
    out = sum(xp[:, i:i + T] * w[i] for i in range(W)) + b
    new_state = xp[:, T:]
    return F.silu(out), new_state


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD, a sequential loop over chunks (the quadratic
    (chunk x chunk) decay/score tensors exist for one chunk at a time).

    x:  (B, T, H, P) inputs;  dt: (B, T, H) softplus'd step sizes
    A:  (H,) negative reals;  Bm/Cm: (B, T, N)
    Returns (y (B,T,H,P) in x's dtype, final_state (B,H,P,N) f32)."""
    Bsz, T, H, P = x.shape
    nc = max(T // chunk, 1)
    chunk = T // nc
    assert nc * chunk == T, (T, chunk)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    state = (torch.zeros((Bsz, H, P, Bm.shape[-1]), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for c0 in range(0, T, chunk):
        xc, dtc = x[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
        Bc = Bm[:, c0:c0 + chunk].float()
        Cc = Cm[:, c0:c0 + chunk].float()
        cum = torch.cumsum(dtc * A, dim=1)                  # (B,c,H) inclusive
        # intra-chunk: L[t,s] = exp(cum[t]-cum[s]) for s<=t
        seg = cum[:, :, None, :] - cum[:, None, :, :]       # (B,t,s,H)
        L = torch.where(tri[None, :, :, None], torch.exp(seg),
                        torch.zeros_like(seg))
        scores = Cc @ Bc.transpose(1, 2)                    # (B,t,s)
        W = scores[..., None] * L                           # (B,t,s,H)
        xdt = (xc * dtc[..., None]).float()                 # (B,s,H,P)
        y_c = torch.einsum("btsh,bshp->bthp", W, xdt)
        # contribution of the state entering this chunk
        y_c = y_c + torch.einsum("btn,bhpn,bth->bthp", Cc, state,
                                 torch.exp(cum))
        # update state to chunk end
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)      # (B,s,H)
        s_local = torch.einsum("bsh,bsn,bshp->bhpn", decay_to_end * dtc, Bc,
                               xc.float())
        state = state * torch.exp(cum[:, -1, :])[:, :, None, None] + s_local
        ys.append(y_c.to(x.dtype))
    return torch.cat(ys, dim=1), state


def ssd_decode_step(state, x, dt, A, Bm, Cm):
    """One-token recurrence.  state: (B,H,P,N); x: (B,H,P); dt: (B,H);
    Bm/Cm: (B,N).  Returns (y (B,H,P), new_state)."""
    dA = torch.exp(dt * A)                                  # (B,H)
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, x.float(), Bm.float())
    new_state = state * dA[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm.float())
    return y.to(x.dtype), new_state


def mamba_block_apply(p: dict, x: torch.Tensor, cfg, *,
                      state: Optional[dict] = None, mode: str = "prefill"):
    """Residual Mamba2 block.

    state: {'ssm': (B,H,P,N) f32, 'conv': (B, W-1, conv_dim)}, or None for
    a zero state.  Returns (y, new_state); new_state is None for
    ``mode="train"``, which runs ``ssd_chunked`` from the zero state, as
    the reference's does, never the kernel.  A prefill with
    ``kernel_impl="pallas"`` and ``state=None`` runs the SSD-scan kernel at
    the chunk ``ssd_chunked`` would use; a prefill from a handed state, or
    with ``kernel_impl="xla"``, runs ``ssd_chunked``.  (The reference also
    sends a T that ``min(ssm_chunk_size, T)`` does not divide to
    ``ssd_chunked``: the same function, which the kernel computes too.)"""
    B, T, d = x.shape
    d_in, H, P, N = dims(cfg)
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    proj = matmul(h, p["in_proj"])
    z, xBC, dt_raw = _split_proj(proj, cfg)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])          # (B,T,H)
    A = -torch.exp(p["A_log"])                              # (H,)

    conv_state = state["conv"] if state is not None else None
    xBC_c, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    xs = xBC_c[..., :d_in].reshape(B, T, H, P)
    Bm = xBC_c[..., d_in:d_in + N]
    Cm = xBC_c[..., d_in + N:]

    if mode == "decode":
        assert T == 1
        y1, new_ssm = ssd_decode_step(state["ssm"], xs[:, 0], dt[:, 0], A,
                                      Bm[:, 0], Cm[:, 0])
        y = y1[:, None]
    elif mode == "prefill" and cfg.kernel_impl == "pallas" and state is None:
        from repro_torch.kernels.ssd_scan.ops import ssd_scan
        chunk = T // max(T // cfg.ssm_chunk_size, 1)
        if is_dtensor(xs):      # on each rank's batch shard, A whole
            (xl, dl, bl, cl), mesh, pl = local_shards(
                "the SSD-scan kernel", (xs, dt, Bm, Cm), (None,) * 4)
            yl, sl = ssd_scan(xl, dl, A.full_tensor(), bl, cl, chunk=chunk)
            y, new_ssm = from_local(yl, mesh, pl), from_local(sl, mesh, pl)
        else:
            y, new_ssm = ssd_scan(xs, dt, A, Bm, Cm, chunk=chunk)
        y = y.to(x.dtype)
    else:
        init = state["ssm"] if state is not None else None
        y, new_ssm = ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk_size, init)

    y = y + xs * p["D"][:, None].to(x.dtype)
    y = y.reshape(B, T, d_in)
    y = rmsnorm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = keep_layout(x + matmul(y, p["out_proj"]), x)
    if mode == "train":
        return out, None
    return out, {"ssm": new_ssm, "conv": new_conv}


def init_mamba_state(cfg, batch: int, dtype=torch.bfloat16, device=None,
                     prefix: tuple = ()) -> dict:
    """Zero state, stacked on ``prefix`` (a group's layer axes)."""
    d_in, H, P, N = dims(cfg)
    conv_dim = d_in + 2 * N
    return {
        "ssm": torch.zeros((*prefix, batch, H, P, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((*prefix, batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
    }
