"""Mixture-of-Experts FFN with GShard-style capacity-based einsum dispatch.

Counterpart of ``repro.models.moe``.  Tokens are routed per *group*
(``ROUTE_GROUP`` tokens during prefill, one group per sequence when the
prompt is not a multiple of it, the whole batch during decode), so the
capacity is a static shape and the dispatch tensor stays O(group * E * C).
The K routing slots are reduced away before the capacity one-hot, so
``dispatch`` is (g, n, E, C), never (g, n, K, E, C).

Every step is a fixed-shape tensor operation with no copy to the host: the
capacity one-hot is a comparison with ``arange(C)`` (a position of -1 or
past the capacity gives a zero row, which is how overflowing tokens are
dropped), so a whole request can be captured in a CUDA graph.  Every expert
runs on every step, holding tokens or not, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

ROUTE_GROUP = 256  # tokens per routing group (static capacity)


def _normal_stack(gen, prefix, shape, dt, device) -> torch.Tensor:
    """A (*prefix, *shape) leaf at 0.02 in ``dt``, drawn one ``shape`` slice
    at a time through one float32 buffer, so the largest temporary is one
    slice, not the stack (a stacked expert leaf of a 48-layer model is
    tens of GB in float32)."""
    out = torch.empty((*prefix, *shape), dtype=dt, device=device)
    buf = torch.empty(shape, dtype=torch.float32, device=device)
    for piece in out.view(-1, *shape):
        torch.randn(shape, generator=gen, device=device, out=buf)
        piece.copy_(buf.mul_(0.02))
    return out


def init_moe(gen, cfg, prefix, dt, device) -> dict:
    """Router (d, E), experts wi and wg (E, d, f) and wo (E, f, d), norm
    (d,), each stacked on ``prefix``; the expert leaves one layer at a
    time (``_normal_stack``)."""
    d, E = cfg.d_model, cfg.num_experts
    f = cfg.moe_d_ff or cfg.d_ff
    return {
        "router": L.normal(gen, (*prefix, d, E), dt, device),
        "wi": _normal_stack(gen, prefix, (E, d, f), dt, device),
        "wg": _normal_stack(gen, prefix, (E, d, f), dt, device),
        "wo": _normal_stack(gen, prefix, (E, f, d), dt, device),
        "norm": torch.ones((*prefix, d), dtype=dt, device=device),
    }


def capacity(tokens_per_group: int, num_experts: int, k: int,
             factor: float = 1.25) -> int:
    c = int(tokens_per_group * k / num_experts * factor)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def router_logits(hg: torch.Tensor, p: dict) -> torch.Tensor:
    """(g, n, d) -> (g, n, E) float32 router logits: the operands in their
    dtype, accumulated in float32 (an exact widening, then a float32
    product)."""
    return torch.einsum("gnd,de->gne", hg.float(), p["router"].float())


def _route(hg: torch.Tensor, p: dict, cfg, C: int):
    """hg: (g, n, d) -> dispatch (g,n,E,C), combine (g,n,E,C), aux scalar."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    probs = torch.softmax(router_logits(hg, p), dim=-1)           # (g, n, E)
    # the first K of a stable descending sort: among equal values the lower
    # index comes first, as ``lax.top_k`` orders them (``torch.topk`` does
    # not promise an order for ties)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[..., :K], gate_idx[..., :K]   # (g, n, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # Slot-major cumulative position inside each expert's capacity buffer
    # (slot 0 of every token before slot 1, GShard semantics).
    experts = torch.arange(E, device=hg.device)
    onehot = (gate_idx[..., None] == experts).float()            # (g, n, K, E)
    g, n = hg.shape[0], hg.shape[1]
    slot_major = onehot.transpose(1, 2).reshape(g, K * n, E)
    pos_sm = torch.cumsum(slot_major, dim=1) - 1.0
    pos = pos_sm.reshape(g, K, n, E).transpose(1, 2)             # (g, n, K, E)

    # A token takes at most one slot per expert -> reduce K away first.
    active = onehot > 0
    pos_r = torch.where(active, pos, -1.0).amax(dim=2)            # (g, n, E)
    gate_r = torch.where(active, gate_vals[..., None], 0.0).sum(dim=2)

    slots = torch.arange(C, dtype=pos_r.dtype, device=hg.device)
    dispatch = (pos_r[..., None] == slots).float()   # 0 if pos < 0 or >= C
    combine = dispatch * gate_r[..., None]

    # Switch-transformer load-balance aux loss.
    frac_tokens = onehot.sum(dim=2).mean(dim=1) / K               # (g, E)
    frac_probs = probs.mean(dim=1)
    aux = E * (frac_tokens * frac_probs).sum(dim=-1).mean()
    return dispatch, combine, aux


def route_groups(h: torch.Tensor) -> torch.Tensor:
    """(B, T, d) -> (g, n, d): groups of ``ROUTE_GROUP`` tokens when T is a
    multiple of it, else one group per sequence; one group of the batch at
    decode (T = 1)."""
    B, T, d = h.shape
    if T > 1:
        n = ROUTE_GROUP if T % ROUTE_GROUP == 0 else T
        return L.safe_view(h, (B * T // n, n, d))
    return L.safe_view(h, (1, B, d))


def _groups_only(t: torch.Tensor) -> torch.Tensor:
    """A DTensor laid out on its leading (group) dim alone: any other
    shard gathered, any pending sum done."""
    from torch.distributed.tensor import Replicate
    want = tuple(p if p.is_shard(0) and type(p).__name__ == "Shard"
                 else Replicate() for p in t.placements)
    return t if want == tuple(t.placements) else t.redistribute(
        t.device_mesh, want)


def moe_apply(p: dict, h: torch.Tensor, cfg) -> tuple:
    """h: (B, T, d) normalized input -> (y, aux_loss)."""
    B, T, d = h.shape
    hg = route_groups(h)
    C = capacity(hg.shape[1], cfg.num_experts, cfg.num_experts_per_tok)

    dispatch, combine, aux = _route(hg, p, cfg, C)

    # on DTensors each operand is first made even (``layers.evenly``): a
    # capacity C rarely divides a mesh axis
    ev = L.evenly
    xin = ev(torch.einsum("gnec,gnd->gecd", ev(dispatch.to(h.dtype)), hg))
    a = torch.einsum("gecd,edf->gecf", xin, p["wg"])
    b = torch.einsum("gecd,edf->gecf", xin, p["wi"])
    out = ev(torch.einsum("gecf,efd->gecd", ev(F.silu(a) * b), p["wo"]))
    if L.is_dtensor(out):   # one product over (e, c) flattened, each
        # operand sharded on its groups only: DTensor's own decomposition
        # of this einsum may shard the capacity unevenly, or lose track of
        # a local shape
        g, n, E, C = combine.shape
        y = _groups_only(combine.to(out.dtype)).reshape(g, n, E * C) \
            @ _groups_only(out).reshape(g, E * C, out.shape[-1])
    else:
        y = torch.einsum("gnec,gecd->gnd", combine.to(out.dtype), out)

    return L.safe_view(y, (B, T, d)), aux


def moe_block_apply(p: dict, x: torch.Tensor, cfg) -> tuple:
    h = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    y, aux = moe_apply(p, h, cfg)
    return x + y, aux
