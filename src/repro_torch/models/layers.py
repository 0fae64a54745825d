"""Shared neural-net layers: norms, RoPE, attention (flash + decode,
self- and cross-attention), MLP, and their random init.

Counterpart of ``repro.models.layers``: plain functions over explicit
parameter dictionaries in the JAX package's layout.  Attention is blockwise
(online softmax over KV blocks, query blocks in an outer loop), the plain
PyTorch mirror of the flash kernel in ``repro_torch.kernels``; its
backward is the reference's custom VJP (``_Flash``), so the train mode
never reaches a kernel, which has no backward.

Every function also runs on DTensors laid out on a ``DeviceMesh``
(``launch/steps.py``): the reference's ``constrain_batch``, a kernel
called on each rank's local shards (``on_shards``), and the few layouts
DTensor cannot view as a partitioner can (``splittable``, ``evenly``,
``_SafeView``) made explicit.  On plain tensors none of it runs.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import is_dtensor
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
# Distributed tensors: the batch constraint, and the kernels on local shards
# ---------------------------------------------------------------------------
def marked(mark, name: str):
    """``mark(name)``: a step's marker of its phase ``name`` (a layer
    group, a train step's forward or backward), which the dry-run passes
    to take each phase's memory peak apart (``perf.roofline.PhaseMarks``);
    nothing where ``mark`` is None."""
    return contextlib.nullcontext() if mark is None else mark(name)


class _OnBackward(torch.autograd.Function):
    """Identity on ``x`` whose backward calls ``fn`` first."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.fn()
        return g, None


def backward_marked(mark, name: str) -> tuple:
    """(``inward``, ``outward``): identities for a stretch of the forward
    (a layer group) whose backward is the phase ``name`` of ``mark``:
    ``outward``, applied to the stretch's output, enters the phase when
    the backward reaches it, and ``inward``, applied to its input, leaves
    it when the backward is through.  So the dry-run takes the backward
    apart as it takes the forward (``perf.roofline.PhaseMarks``).  Both
    return their tensor as it is where ``mark`` is None."""
    if mark is None:
        return (lambda x: x), (lambda x: x)
    open_ = []

    def enter():
        open_.append(mark(name))
        open_[-1].__enter__()

    def leave():
        if open_:
            open_.pop().__exit__(None, None, None)
    return ((lambda x: _OnBackward.apply(x, leave)),
            (lambda x: _OnBackward.apply(x, enter)))


def constrain_batch(x: torch.Tensor, bspec) -> torch.Tensor:
    """Lay a DTensor activation out with its leading (batch) axis over the
    mesh axes ``bspec`` and every other axis whole, as the reference's
    ``with_sharding_constraint`` to ``P(bspec, None, ...)``.  A plain
    tensor, or ``bspec`` None, is returned as it is."""
    if bspec is None or not is_dtensor(x):
        return x
    from repro_torch.distributed.sharding import to_placements
    want = to_placements((bspec,) + (None,) * (x.ndim - 1), x.device_mesh)
    return x if tuple(x.placements) == want else x.redistribute(
        x.device_mesh, want)


def keep_layout(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``y`` (a block's output on the residual stream) laid out as the
    block's input ``like``: the stream keeps one layout through a layer,
    as the reference's scan carries one, where DTensor would leave a
    pending sum or a strided shard for the next view to trip on.  Plain
    tensors are returned as they are."""
    if not is_dtensor(y) or tuple(y.placements) == tuple(like.placements):
        return y
    return y.redistribute(like.device_mesh, like.placements)


def settled(t):
    """A DTensor with its pending (partial) reductions done."""
    from torch.distributed.tensor import Replicate
    want = tuple(Replicate() if p.is_partial() else p for p in t.placements)
    return t if tuple(t.placements) == want else t.redistribute(
        t.device_mesh, want)


def _whole(ts: tuple, head_dims: tuple, skip: Optional[int] = None) -> bool:
    """Do DTensors ``ts``' placements keep each rank's attention whole: on
    every mesh dim of more than one rank (but ``skip``), all replicated,
    all sharded on the batch (dim 0), or all on their head dims
    (``head_dims``, one per operand, aligned as the reference's head TP
    aligns Q and KV heads; None: an operand with no head dim)?"""
    mesh = ts[0].device_mesh
    for i in range(mesh.ndim):
        if mesh.size(i) == 1 or i == skip:
            continue
        pls = [t.placements[i] for t in ts]
        if not (all(p.is_replicate() for p in pls)
                or all(p.is_shard(0) for p in pls)
                or all(h is not None and p.is_shard(h)
                       for p, h in zip(pls, head_dims))):
            return False
    return True


def local_shards(what: str, tensors: tuple, head_dims: tuple,
                 skip: Optional[int] = None):
    """The local shards of DTensor attention operands, for a kernel that
    runs on each rank's own part: allowed only where the placements keep
    each rank's attention whole (``_whole``; pending sums are done
    first).  Anything else (a sequence-sharded cache, Q heads sharded over
    replicated K/V) raises ``NotImplementedError`` naming the placements:
    a kernel call under a mesh never quietly takes the plain version.
    Returns (the local tensors, the first operand's mesh and
    placements)."""
    ts = tuple(settled(t) for t in tensors)
    if not _whole(ts, head_dims, skip):
        raise NotImplementedError(
            f"{what} on local shards needs each rank's attention whole "
            f"(batch or aligned head shards); placements "
            f"{[tuple(t.placements) for t in ts]} over mesh dims "
            f"{ts[0].device_mesh.mesh_dim_names}")
    return tuple(t.to_local() for t in ts), ts[0].device_mesh, ts[0].placements


def from_local(t: torch.Tensor, mesh, placements):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, placements, run_check=False)


def on_shards(what: str, fn, tensors: tuple, head_dims: tuple):
    """``fn(*tensors)``; on DTensors, ``fn`` of their local shards
    (``local_shards``), its result laid out as the first operand."""
    if not is_dtensor(tensors[0]):
        return fn(*tensors)
    locs, mesh, placements = local_shards(what, tensors, head_dims)
    return from_local(fn(*locs), mesh, placements)


def _seq_parallel(attend, q, k, v, seq_axis: str):
    """The reference's sequence-parallel prefill (``seq_axis``): the query
    rows are sharded over the mesh axis ``seq_axis`` in contiguous runs
    (whole 256-row blocks where the steps' rule applies), and each rank
    attends its own rows against the whole K/V, its first row's position
    as ``q_offset``.  The output keeps the rows sharded."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    i = mesh.mesh_dim_names.index(seq_axis)
    if q.shape[1] % mesh.size(i):
        raise ValueError(f"{q.shape[1]} query rows do not split evenly "
                         f"over {mesh.size(i)} ranks of {seq_axis!r}")

    def placed(t, p):
        pl = list(settled(t).placements)
        pl[i] = p
        return t.redistribute(mesh, tuple(pl))
    q = placed(q, Shard(1))
    k, v = placed(k, Replicate()), placed(v, Replicate())
    (ql, kl, vl), _, _ = local_shards("sequence-parallel attention",
                                      (q, k, v), (2, 2, 2), skip=i)
    off = mesh.get_local_rank(i) * ql.shape[1]
    return from_local(attend(ql, kl, vl, off), mesh, q.placements)


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

    def total(terms):
        """The terms summed in order (from the first, as a zero
        accumulator's += gives them)."""
        acc = None
        for t in terms:
            acc = t if acc is None else acc + t
        return acc

    # pass A: dq (q-block major, kv blocks inner)
    dq = torch.stack([total(
        torch.einsum("bkgqs,bskd->bqkgd", ds_block(qi, ki)[1], k32[:, ki])
        for ki in range(nk)) for qi in range(nq)], dim=1) * scale

    # pass B: dk, dv (kv-block major, q blocks inner)
    dks, dvs = [], []
    for ki in range(nk):
        dk_terms, dv_terms = [], []
        for qi in range(nq):
            p, ds = ds_block(qi, ki)
            dv_terms.append(torch.einsum("bkgqs,bqkgd->bskd", p,
                                         dout32[:, qi]))
            dk_terms.append(torch.einsum("bkgqs,bqkgd->bskd", ds,
                                         q[:, qi].float() * scale))
        dks.append(total(dk_terms))
        dvs.append(total(dv_terms))
    dk, dv = torch.stack(dks, dim=1), torch.stack(dvs, dim=1)
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
    if is_dtensor(q):
        # each rank's own attention, where its shards hold it whole: the
        # same arithmetic on local tensors (a partial sum done first; Q
        # heads sharded where the KV heads are not, q-TP, gathered first,
        # as the blocking below needs them)
        ts = tuple(settled(t) for t in (splittable(q, 2, k.shape[2]), k, v))
        if _whole(ts, (2, 2, 2)):
            locs, mesh, placements = local_shards("attention", ts, (2, 2, 2))
            return from_local(flash_attention(
                *locs, causal=causal, window=window, logit_cap=logit_cap,
                q_offset=q_offset, kv_valid_len=kv_valid_len,
                block_q=block_q, block_k=block_k), mesh, placements)
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
    q = splittable(q, 2, KV)
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
    return evenly(safe_view(out, (B, nq * block_q, H, hd)))[:, :Tq]


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
    qh = (splittable(q, 1, KV).reshape(B, KV, G, hd) * scale).float()
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
def splittable(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t``, a DTensor laid out so that ``dim`` can be split into (n,
    ...): a mesh dim sharding ``dim`` that does not divide ``n`` is
    gathered (DTensor refuses an uneven split where a partitioner
    reshards; e.g. q-TP's Q heads over 'model' when the KV heads do not
    divide it).  A plain tensor is returned as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    mesh, dim = t.device_mesh, dim % t.ndim
    want = tuple(Replicate() if p.is_shard(dim) and n % mesh.size(i) else p
                 for i, p in enumerate(t.placements))
    return t if want == tuple(t.placements) else t.redistribute(mesh, want)


def evenly(t: torch.Tensor) -> torch.Tensor:
    """``t``, a DTensor with every dim a mesh dim shards unevenly, or in
    strides (a flattened view's ``_StridedShard``), gathered on that mesh
    dim: DTensor keeps such a shard (an MoE capacity of 40 over 16 ranks)
    and then refuses to view it.  A plain tensor is returned as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    mesh = t.device_mesh
    want = tuple(p if p.is_replicate() or p.is_partial() or (
        type(p) is Shard and not t.shape[p.dim] % mesh.size(i))
        else Replicate() for i, p in enumerate(t.placements))
    return t if want == tuple(t.placements) else t.redistribute(mesh, want)


def unflatten_last(y: torch.Tensor, sizes: tuple) -> torch.Tensor:
    """``y.unflatten(-1, sizes)``, a DTensor first made ``splittable``
    (DTensor may shard a product's output dim wherever its inputs
    allow)."""
    return splittable(y, -1, sizes[0]).unflatten(-1, sizes)


class _SafeView(torch.autograd.Function):
    """A DTensor's ``reshape`` whose backward first lays the gradient out
    as the forward's result was (a pending sum's gradient whole): DTensor
    may shard a gradient (a product's weight gradient, an attention
    output's) on a dim that the view back to the input's shape cannot
    split evenly.  ``keep_sums``: a pending sum on a mesh dim where the
    result was whole stays pending (a view of it is exact), for a
    weight's gradient, which the weight's per-layer gather then
    reduce-scatters onto its shard once (``distributed.fsdp``)."""

    @staticmethod
    def forward(ctx, w, shape, keep_sums=False):
        from torch.distributed.tensor import Replicate
        out = w.reshape(shape)
        ctx.w_shape, ctx.keep_sums = w.shape, keep_sums
        ctx.layout = tuple(Replicate() if p.is_partial() else p
                           for p in out.placements)
        return out

    @staticmethod
    def backward(ctx, g):
        want = ctx.layout
        if ctx.keep_sums:
            want = tuple(p if p.is_partial() and w.is_replicate() else w
                         for p, w in zip(g.placements, want))
        if tuple(g.placements) != want:
            g = g.redistribute(g.device_mesh, want)
        return g.reshape(ctx.w_shape), None, None


def safe_view(t: torch.Tensor, shape: tuple) -> torch.Tensor:
    return _SafeView.apply(t, shape) if is_dtensor(t) else t.reshape(shape)


def weight_view(w: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``safe_view`` of a weight: its gradient's pending sums stay pending
    (``_SafeView``'s ``keep_sums``)."""
    return _SafeView.apply(w, shape, True) if is_dtensor(w) \
        else w.reshape(shape)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` whose backward takes the result's gradient as the result
    was laid out (``_SafeView``): DTensor may hand a product a gradient
    sharded on the flattened (batch x time) rows, or unevenly over them,
    which the product's backward cannot view back to ``x``'s shape."""
    y = x @ w
    return _SafeView.apply(y, y.shape) if (is_dtensor(y)
                                           and y.requires_grad) else y


def _proj_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('btd,dhx->bthx') as one matrix product."""
    d, h, hx = w.shape
    return unflatten_last(matmul(x, weight_view(w, (d, h * hx))), (h, hx))


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
    return matmul(o.flatten(-2), weight_view(w, (h * hx, d)))


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
    write: bool = True,                 # decode: write the new K/V in place
    seq_axis: Optional[str] = None,     # sequence-parallel prefill mesh axis
):
    """Returns (y, new_kv): new_kv is (k, v) for prefill, the new token's
    (k, v) (B, KV, 1, hd) for decode (the delta the reference's decode
    returns) and None for train.

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
    one the reference's ``decode_step`` returns.  ``write=False`` leaves
    the cache unwritten, for a caller that applies the returned delta
    itself (the reference's ``return_deltas``): the plain path attends the
    new token beside the cache; the decode kernel reads it from the cache,
    so on the kernel path the slot is written all the same, with the
    value the caller's append writes again.

    On DTensors (a mesh) the kernel path runs each kernel on the local
    shards (``on_shards``), which it allows only where each rank's
    attention is whole, and raises otherwise; ``seq_axis`` shards the
    prefill's query rows over that mesh axis (``_seq_parallel``), on
    either path.  The cache writes go to each rank's own shard
    (``distributed.cache_update``)."""
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
        kernel = cfg.kernel_impl == "pallas" and not ring
        slot = (cache_pos % capacity) if ring else cache_pos
        if write or kernel:             # the kernel reads the new token there
            if is_dtensor(kc):
                from repro_torch.distributed.cache_update import append_kv
                append_kv(kc, k_new, cache_pos, axis=2)
                append_kv(vc, v_new, cache_pos, axis=2)
            else:
                idx = torch.as_tensor(slot, device=x.device).reshape(1).long()
                kc.index_copy_(2, idx, k_new)
                vc.index_copy_(2, idx, v_new)
        if kernel:
            from repro_torch.kernels.decode_attention.ops import \
                decode_attention_kvmajor
            pos = cache_pos.to_local() if is_dtensor(cache_pos) else cache_pos
            o = on_shards("the decode kernel",
                          lambda q0, kl, vl: decode_attention_kvmajor(
                              q0, kl, vl, pos, window=window,
                              logit_cap=cfg.attn_logit_softcap),
                          (q[:, 0], kc, vc), (1, 1, 1))
        else:
            o = decode_attention(q[:, 0], kc, vc,
                                 capacity if ring else cache_pos,
                                 window=None if ring else window,
                                 logit_cap=cfg.attn_logit_softcap,
                                 k_new=k_new, v_new=v_new,
                                 exclude_slot=slot if ring else None)
        o = o[:, None]                                  # (B, 1, H, hd)
        new_kv = {"k": k_new, "v": v_new}
    elif mode == "prefill":
        cap = cfg.attn_logit_softcap
        if cfg.kernel_impl == "pallas":
            from repro_torch.kernels.flash_attention.ops import \
                flash_attention as kernel_flash

            def attend(q, k, v, q_offset=0):
                return kernel_flash(q, k, v, causal=causal, window=window,
                                    logit_cap=cap, q_offset=q_offset)
        else:
            def attend(q, k, v, q_offset=0):
                return flash_attention(q, k, v, causal=causal, window=window,
                                       logit_cap=cap, q_offset=q_offset)
        if seq_axis is not None and is_dtensor(q):
            o = _seq_parallel(attend, q, k, v, seq_axis)
        elif cfg.kernel_impl == "pallas":
            o = on_shards("the flash kernel", attend, (q, k, v), (2, 2, 2))
        else:
            o = attend(q, k, v)
        new_kv = {"k": k, "v": v}
    else:
        o = flash_attention(q, k, v, causal=causal, window=window,
                            logit_cap=cfg.attn_logit_softcap)
        new_kv = None

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
        o = on_shards("the decode kernel",
                      lambda q0, kt, vt: decode_attention_kvmajor(
                          q0, kt, vt, enc_last, logit_cap=cap),
                      (q[:, 0], k.transpose(1, 2), v.transpose(1, 2)),
                      (1, 1, 1))[:, None]
    else:
        from repro_torch.kernels.flash_attention.ops import \
            flash_attention as kernel_flash
        o = on_shards("the flash kernel",
                      lambda q, k, v: kernel_flash(q, k, v, causal=False,
                                                   logit_cap=cap),
                      (q, k, v), (2, 2, 2))
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
    y = matmul(F.silu(matmul(h, p["wg"])) * matmul(h, p["wi"]), p["wo"])
    if cfg.post_block_norm:
        y = rmsnorm(y, p["post_norm"], cfg.norm_eps)
    return x + y
