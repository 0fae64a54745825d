"""Shared neural-net layers: norms, RoPE, attention (flash + decode,
self- and cross-attention), MLP, and their random init.

Counterpart of ``repro.models.layers``: plain functions over explicit
parameter dictionaries in the JAX package's layout.  Attention is blockwise
(online softmax over KV blocks, query blocks in an outer loop), the plain
PyTorch mirror of the flash kernel in ``repro_torch.kernels``; its
backward is the reference's custom VJP (``_Flash``), so the train mode
never reaches a kernel, which has no backward.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.perf import autotune

NEG_INF = -2.0 ** 30  # large-negative that survives bf16 softmax math in f32

# Block sizes of the plain blockwise attention when the caller gives none
# and the autotune cache has none (the reference's defaults); read at call
# time.
DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_K = 512


# ---------------------------------------------------------------------------
# Parameter init (random, from an explicit torch.Generator), each leaf stacked
# on ``prefix``: ``(count,)`` for a stacked group, ``()`` for one block
# ---------------------------------------------------------------------------
def normal(gen, shape, dt, device):
    """A float32 draw at 0.02, scaled in place and cast to ``dt``: one
    float32 temporary of the leaf beside its result."""
    return torch.randn(shape, generator=gen, device=device).mul_(0.02).to(dt)


def init_attn_block(gen, cfg, prefix, dt, device, *,
                    cross: bool = False) -> dict:
    """``cross``: a decoder's cross-attention block, which adds the
    ``cross_norm`` its query side is normed by."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": normal(gen, (*prefix, d, H, hd), dt, device),
        "wk": normal(gen, (*prefix, d, KV, hd), dt, device),
        "wv": normal(gen, (*prefix, d, KV, hd), dt, device),
        "wo": normal(gen, (*prefix, H, hd, d), dt, device),
        "norm": torch.ones((*prefix, d), dtype=dt, device=device),
    }
    if cfg.attention_bias:
        p["bq"] = torch.zeros((*prefix, H, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((*prefix, KV, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((*prefix, KV, hd), dtype=dt, device=device)
    if cfg.post_block_norm:
        p["post_norm"] = torch.ones((*prefix, d), dtype=dt, device=device)
    if cross:
        p["cross_norm"] = torch.ones((*prefix, d), dtype=dt, device=device)
    return p


def init_mlp(gen, cfg, prefix, dt, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    p = {
        "wi": normal(gen, (*prefix, d, f), dt, device),
        "wg": normal(gen, (*prefix, d, f), dt, device),
        "wo": normal(gen, (*prefix, f, d), dt, device),
        "norm": torch.ones((*prefix, d), dtype=dt, device=device),
    }
    if cfg.post_block_norm:
        p["post_norm"] = torch.ones((*prefix, d), dtype=dt, device=device)
    return p


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding. x: (..., T, H, hd); positions broadcastable to (..., T)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs                # (..., T, half)
    cos = torch.cos(angles)[..., None, :]                        # (..., T, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Blockwise flash attention (plain PyTorch) — training and prefill path.
# ---------------------------------------------------------------------------
def _pad_axis(x: torch.Tensor, axis: int, multiple: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % multiple
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - axis - 1) + [0, pad]
    return F.pad(x, widths)


def _mask_for(qpos, kpos, causal, window, kv_len):
    mask = (kpos[None, :] < kv_len)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    return mask


def _scores(qblk, kblk, logit_cap, qpos, kpos, causal, window, kv_len):
    """qblk pre-scaled (B,bq,KV,G,hd) f32; kblk (B,bk,KV,hd) f32 ->
    (s_capped, raw) both (B,KV,G,bq,bk) f32, masked with NEG_INF."""
    raw = torch.einsum("bqkgd,bskd->bkgqs", qblk, kblk)
    s = softcap(raw, logit_cap)
    mask = _mask_for(qpos, kpos, causal, window, kv_len)
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), raw


def _flash_fwd_res(static, q, k, v):
    """q: (B, nq, bq, KV, G, hd); k/v: (B, nk, bk, KV, hd).
    Returns (out (B,nq,bq,KV,G,hd) in q's dtype, lse (B,KV,G,nq,bq) f32)."""
    causal, window, logit_cap, q_offset, kv_len = static
    B, nq, bq, KV, G, hd = q.shape
    nk, bk = k.shape[1], k.shape[2]
    k = k.float()
    scale = hd ** -0.5
    dev = q.device
    outs, lses = [], []
    for qi in range(nq):
        qblk = (q[:, qi] * scale).float()                      # (B,bq,KV,G,hd)
        qpos = q_offset + qi * bq + torch.arange(bq, device=dev)
        m = torch.full((B, KV, G, bq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, bq, KV, G, hd), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            kpos = ki * bk + torch.arange(bk, device=dev)
            s, _ = _scores(qblk, k[:, ki], logit_cap, qpos, kpos, causal,
                           window, kv_len)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(),
                              v[:, ki].float())
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        l = torch.clamp(l, min=1e-30)
        outs.append((acc / l.permute(0, 3, 1, 2)[..., None]).to(q.dtype))
        lses.append(m + torch.log(l))                          # (B,KV,G,bq)
    return torch.stack(outs, dim=1), torch.stack(lses, dim=3)


def _flash_bwd(static, q, k, v, out, lse, dout):
    """The reference's flash backward (``_flash_vjp_bwd``): scores are
    recomputed block by block from the saved ``lse``, so no (bq x bk)
    probabilities are kept from the forward.  Pass A takes dq q-block
    major, pass B dk and dv kv-block major; everything accumulates in
    float32 and is cast to the inputs' dtypes at the end."""
    causal, window, logit_cap, q_offset, kv_len = static
    B, nq, bq, KV, G, hd = q.shape
    nk, bk = k.shape[1], k.shape[2]
    scale = hd ** -0.5
    dev = q.device
    k32, v32, dout32 = k.float(), v.float(), dout.float()
    # D_i = rowsum(dO * O): (B, KV, G, nq, bq)
    delta = torch.einsum("bnqkgd,bnqkgd->bkgnq", dout32, out.float())

    def ds_block(qi, ki):
        """p and ds (B,KV,G,bq,bk) f32 of one (q-block, kv-block) pair."""
        qblk = (q[:, qi] * scale).float()
        qpos = q_offset + qi * bq + torch.arange(bq, device=dev)
        kpos = ki * bk + torch.arange(bk, device=dev)
        s, raw = _scores(qblk, k32[:, ki], logit_cap, qpos, kpos, causal,
                         window, kv_len)
        p = torch.exp(s - lse[:, :, :, qi, :, None])
        dp = torch.einsum("bqkgd,bskd->bkgqs", dout32[:, qi], v32[:, ki])
        ds = p * (dp - delta[:, :, :, qi, :, None])
        if logit_cap is not None:
            ds = ds * (1.0 - torch.tanh(raw / logit_cap).square())
        return p, ds

    # pass A: dq (q-block major, kv blocks inner)
    dq = torch.zeros((B, nq, bq, KV, G, hd), dtype=torch.float32, device=dev)
    for qi in range(nq):
        for ki in range(nk):
            _, ds = ds_block(qi, ki)
            dq[:, qi] += torch.einsum("bkgqs,bskd->bqkgd", ds, k32[:, ki])
    dq = dq * scale

    # pass B: dk, dv (kv-block major, q blocks inner)
    dk = torch.zeros((B, nk, bk, KV, hd), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for ki in range(nk):
        for qi in range(nq):
            p, ds = ds_block(qi, ki)
            dv[:, ki] += torch.einsum("bkgqs,bqkgd->bskd", p, dout32[:, qi])
            dk[:, ki] += torch.einsum("bkgqs,bqkgd->bskd", ds,
                                      q[:, qi].float() * scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """Blockwise attention over padded, blocked q/k/v with the reference's
    custom VJP: the forward saves ``lse`` and the backward recomputes the
    scores (``_flash_bwd``)."""

    @staticmethod
    def forward(ctx, static, q, k, v):
        out, lse = _flash_fwd_res(static, q, k, v)
        ctx.static = static
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        return (None, *_flash_bwd(ctx.static, *ctx.saved_tensors, dout))


def flash_attention(
    q: torch.Tensor,             # (B, Tq, H, hd)
    k: torch.Tensor,             # (B, Tk, KV, hd)
    v: torch.Tensor,             # (B, Tk, KV, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    q_offset: int = 0,           # absolute position of q[0] (prefill continuation)
    kv_valid_len: Optional[int] = None,    # mask k positions >= this
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Online-softmax attention with O(block_q * block_k) live scores,
    differentiable through the reference's blockwise-recomputing backward
    (``_Flash``), for training and prefill alike.

    Numerics follow the reference: q is scaled in its own dtype, scores and
    the softmax state are float32, and P is cast to v's dtype before the
    PV product.  On the CPU, block sizes left None defer to the autotune
    cache for this shape class and dtype; explicit ones win, and an empty
    cache gives ``DEFAULT_BLOCK_Q`` / ``DEFAULT_BLOCK_K``.  On a card the
    cache's flash entry is the flash kernel's tile, never timed for this
    function, so there the defaults always apply: the plain version the
    kernels are held against does not move with the cache."""
    B, Tq, H, hd = q.shape
    _, Tk, KV, _ = k.shape
    assert H % KV == 0, (H, KV)
    G = H // KV
    cfg = None
    if (block_q is None or block_k is None) and q.device.type == "cpu":
        cfg = autotune.lookup("flash_attention", q.dtype, device=q.device,
                              BKV=B * KV, G=G, hd=hd, Tq=max(Tq, 1),
                              Tk=max(Tk, 1), causal=causal)
    if block_q is None:
        block_q = cfg["block_q"] if cfg else DEFAULT_BLOCK_Q
    if block_k is None:
        block_k = cfg["block_k"] if cfg else DEFAULT_BLOCK_K
    block_q = min(block_q, max(Tq, 1))
    block_k = min(block_k, max(Tk, 1))
    qp = _pad_axis(q, 1, block_q)
    kp = _pad_axis(k, 1, block_k)
    vp = _pad_axis(v, 1, block_k)
    nq = qp.shape[1] // block_q
    nk = kp.shape[1] // block_k
    qp = qp.reshape(B, nq, block_q, KV, G, hd)
    kp = kp.reshape(B, nk, block_k, KV, hd)
    vp = vp.reshape(B, nk, block_k, KV, hd)
    kv_len = Tk if kv_valid_len is None else kv_valid_len
    static = (causal, window, logit_cap, q_offset, kv_len)
    out = _Flash.apply(static, qp, kp, vp)             # (B,nq,bq,KV,G,hd)
    return out.reshape(B, nq * block_q, H, hd)[:, :Tq]


# ---------------------------------------------------------------------------
# Single-token decode attention against a KV cache (plain PyTorch; the CUDA
# kernel in repro_torch.kernels.decode_attention computes the same thing).
# ---------------------------------------------------------------------------
def decode_attention(
    q: torch.Tensor,        # (B, H, hd) — one new token per sequence
    k_cache: torch.Tensor,  # (B, KV, S, hd)
    v_cache: torch.Tensor,
    pos,                    # int or 0-d tensor
    *,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    k_new: Optional[torch.Tensor] = None,   # (B, KV, 1, hd): the new token's
    v_new: Optional[torch.Tensor] = None,   # K/V, attended separately
    exclude_slot=None,                      # ring buffers: stale slot to mask
) -> torch.Tensor:
    B, H, hd = q.shape
    _, KV, S, _ = k_cache.shape
    G = H // KV
    scale = hd ** -0.5
    qh = (q.reshape(B, KV, G, hd) * scale).float()
    s = softcap(torch.einsum("bkgd,bksd->bkgs", qh, k_cache.float()),
                logit_cap)
    kpos = torch.arange(S, device=q.device)
    # with k_new provided, the cache holds positions < pos (slot pos stale)
    mask = (kpos < pos) if k_new is not None else (kpos <= pos)
    if window is not None:
        mask = mask & (kpos > pos - window)
    if exclude_slot is not None:
        mask = mask & (kpos != exclude_slot)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    if k_new is None:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgs,bksd->bkgd", p.to(v_cache.dtype).float(),
                           v_cache.float())
        return out.reshape(B, H, hd).to(q.dtype)

    # two-part softmax: the cache scores and the new token's self-score are
    # merged through an explicit max / denominator, as in the reference
    s_self = softcap(torch.einsum("bkgd,bkxd->bkgx", qh, k_new.float()),
                     logit_cap)
    m = torch.maximum(s.amax(dim=-1, keepdim=True), s_self)    # (B,KV,G,1)
    p_cache = torch.exp(s - m)
    p_self = torch.exp(s_self - m)
    denom = p_cache.sum(dim=-1, keepdim=True) + p_self
    out = torch.einsum("bkgs,bksd->bkgd", p_cache.to(v_cache.dtype).float(),
                       v_cache.float())
    out = out + torch.einsum("bkgx,bkxd->bkgd", p_self.to(v_new.dtype).float(),
                             v_new.float())
    out = out / denom
    return out.reshape(B, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention block (pre-norm [+ optional post-norm], GQA, RoPE, residual)
# ---------------------------------------------------------------------------
def _proj_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('btd,dhx->bthx') as one matrix product."""
    d, h, hx = w.shape
    return (x @ w.reshape(d, h * hx)).unflatten(-1, (h, hx))


def qkv_proj(p: dict, x: torch.Tensor, cfg):
    q = _proj_in(x, p["wq"])
    k = _proj_in(x, p["wk"])
    v = _proj_in(x, p["wv"])
    if cfg.attention_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def _proj_out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bthx,hxd->btd') as one matrix product."""
    h, hx, d = w.shape
    return o.flatten(-2) @ w.reshape(h * hx, d)


def attn_block_apply(
    p: dict,
    x: torch.Tensor,                    # (B, T, d)
    cfg,
    *,
    window: Optional[int] = None,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,   # (T,) absolute positions
    cache: Optional[dict] = None,       # {'k','v'}: (B, KV, S, hd) — decode only
    cache_pos: Optional[torch.Tensor] = None,   # 0-d int tensor
    mode: str = "prefill",              # train | prefill | decode
    ring: bool = False,                 # windowed ring-buffer cache (decode)
):
    """Returns (y, new_kv): new_kv is (k, v) for prefill and None for train
    and decode.

    Train runs the plain blockwise attention, whatever ``cfg.kernel_impl``
    says: the kernels have no backward.  Prefill with ``causal=False`` is
    the encoder's bidirectional pass over the whole sequence (the
    reference's ``mode="train"`` there); on the kernel path it takes the
    flash kernel as the causal prefill does.

    Decode writes the new token's K/V into ``cache`` IN PLACE, at slot
    ``cache_pos`` (``cache_pos % capacity`` for a ring), before attending.
    The reference instead copied each layer's whole cache with a dynamic
    update slice and wrote the delta again after the layer scan; on the GPU
    a full per-layer cache copy every step would dominate the step, while
    the in-place write moves one slot.  The cache left behind equals the
    one the reference's ``decode_step`` returns."""
    B, T, d = x.shape
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    q, k, v = qkv_proj(p, h, cfg)
    if positions is None:
        positions = torch.arange(T, device=x.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if mode == "decode":
        assert cache is not None and T == 1
        kc, vc = cache["k"], cache["v"]
        capacity = kc.shape[2]
        k_new = k.transpose(1, 2).to(kc.dtype)          # (B, KV, 1, hd)
        v_new = v.transpose(1, 2).to(vc.dtype)
        slot = (cache_pos % capacity) if ring else cache_pos
        slot = torch.as_tensor(slot, device=x.device).reshape(1).long()
        kc.index_copy_(2, slot, k_new)
        vc.index_copy_(2, slot, v_new)
        if cfg.kernel_impl == "pallas" and not ring:
            from repro_torch.kernels.decode_attention.ops import \
                decode_attention_kvmajor
            o = decode_attention_kvmajor(q[:, 0], kc, vc, cache_pos,
                                         window=window,
                                         logit_cap=cfg.attn_logit_softcap)
        else:
            o = decode_attention(q[:, 0], kc, vc,
                                 capacity if ring else cache_pos,
                                 window=None if ring else window,
                                 logit_cap=cfg.attn_logit_softcap,
                                 k_new=k_new, v_new=v_new,
                                 exclude_slot=slot[0] if ring else None)
        o = o[:, None]                                  # (B, 1, H, hd)
        new_kv = None
    elif mode == "prefill" and cfg.kernel_impl == "pallas":
        from repro_torch.kernels.flash_attention.ops import \
            flash_attention as kernel_flash
        o = kernel_flash(q, k, v, causal=causal, window=window,
                         logit_cap=cfg.attn_logit_softcap)
        new_kv = {"k": k, "v": v}
    else:
        o = flash_attention(q, k, v, causal=causal, window=window,
                            logit_cap=cfg.attn_logit_softcap)
        new_kv = {"k": k, "v": v} if mode == "prefill" else None

    y = _proj_out(o, p["wo"])
    if cfg.post_block_norm:
        y = rmsnorm(y, p["post_norm"], cfg.norm_eps)
    return x + y, new_kv


def cross_attn_apply(p: dict, x: torch.Tensor, enc_kv: dict, cfg, *,
                     enc_last: Optional[torch.Tensor] = None,
                     mode: str = "prefill") -> torch.Tensor:
    """Cross-attention over precomputed encoder K/V (no positions, no mask).
    enc_kv: {'k','v'}: (B, S_enc, KV, hd).

    On the kernel path a prompt goes to the flash kernel with
    ``causal=False``, and one decode token to the decode kernel, which
    reads the keys through a (B, KV, S_enc, hd) view of the cache, no
    copy, at position ``S_enc - 1``, where every key is valid.
    ``enc_last`` holds that position as a (1,) int32 tensor on the device,
    made once per step by the caller (a CUDA-graph capture takes no copy
    from the host); None makes it here.  The plain path, and
    ``mode="train"`` on either path, runs the blockwise
    ``flash_attention``, as the reference does for all three."""
    h = rmsnorm(x, p["cross_norm"], cfg.norm_eps)
    q = _proj_in(h, p["wq"])
    if cfg.attention_bias:
        q = q + p["bq"]
    k, v = enc_kv["k"], enc_kv["v"]
    cap = cfg.attn_logit_softcap
    if cfg.kernel_impl != "pallas" or mode == "train":
        o = flash_attention(q, k, v, causal=False, logit_cap=cap)
    elif x.shape[1] == 1:
        from repro_torch.kernels.decode_attention.ops import \
            decode_attention_kvmajor
        if enc_last is None:
            enc_last = torch.full((1,), k.shape[1] - 1, dtype=torch.int32,
                                  device=x.device)
        o = decode_attention_kvmajor(q[:, 0], k.transpose(1, 2),
                                     v.transpose(1, 2), enc_last,
                                     logit_cap=cap)[:, None]
    else:
        from repro_torch.kernels.flash_attention.ops import \
            flash_attention as kernel_flash
        o = kernel_flash(q, k, v, causal=False, logit_cap=cap)
    return x + _proj_out(o, p["wo"])


def encode_kv(p: dict, enc_out: torch.Tensor, cfg) -> dict:
    """Cross-attention K/V (B, S_enc, KV, hd) of the encoder's output."""
    k = _proj_in(enc_out, p["wk"])
    v = _proj_in(enc_out, p["wv"])
    if cfg.attention_bias:
        k = k + p["bk"]
        v = v + p["bv"]
    return {"k": k, "v": v}


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def mlp_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    y = (F.silu(h @ p["wg"]) * (h @ p["wi"])) @ p["wo"]
    if cfg.post_block_norm:
        y = rmsnorm(y, p["post_norm"], cfg.norm_eps)
    return x + y
