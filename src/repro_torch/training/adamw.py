"""AdamW with decoupled weight decay over a parameter tree (dicts and
lists of tensors), the counterpart of ``repro.training.adamw``.

Functional, as the reference's: ``update`` returns new parameters and a new
state and changes nothing it is given.  Not ``torch.optim.AdamW``, whose
semantics differ (no global-norm clip, decay on every leaf).  The moments
are float32 whatever a leaf's dtype; the global gradient norm stays on the
device, so a step waits on no copy to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor     # 0-d int32
    mu: dict
    nu: dict


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts and lists;
    anything else is a leaf), keeping the structure."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, list):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves`` order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def init(params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _new_values(g, m, v, p, scale, c1, c2, *, lr, b1, b2, eps,
                weight_decay, decay: bool):
    """One leaf's (or piece's) new parameter, first and second moment."""
    g = g.float() * scale
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g.square()
    dp = (m / c1) / (torch.sqrt(v / c2) + eps)
    if decay:  # decoupled weight decay on matrices only
        dp = dp + weight_decay * p.float()
    return (p.float() - lr * dp).to(p.dtype), m, v


def _clip_and_bias(grads, step, b1, b2, max_grad_norm):
    """(gnorm, the clip scale, the two bias corrections) of a step."""
    gnorm = torch.sqrt(sum(g.float().square().sum()
                           for g in tree_leaves(grads)))
    scale = torch.clamp(max_grad_norm / gnorm.clamp_min(1e-9), max=1.0)
    t = step.float()
    return gnorm, scale, 1 - b1 ** t, 1 - b2 ** t


@torch.no_grad()
def update(grads, state: AdamWState, params, *, lr: float = 3e-4,
           b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
           weight_decay: float = 0.1, max_grad_norm: float = 1.0):
    """Returns (new_params, new_state, gnorm): the gradients clipped to a
    global norm of ``max_grad_norm``, decay only on leaves of two or more
    dimensions, each new leaf cast back to its parameter's dtype."""
    step = state.step + 1
    gnorm, scale, c1, c2 = _clip_and_bias(grads, step, b1, b2, max_grad_norm)
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    out = tree_map(lambda g, m, v, p: _new_values(
        g, m, v, p, scale, c1, c2, decay=p.ndim >= 2, **kw),
        grads, state.mu, state.nu, params)
    pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
    return pick(0), AdamWState(step=step, mu=pick(1), nu=pick(2)), gnorm


@torch.no_grad()
def update_(grads, state: AdamWState, params, *, stacked=None,
            lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
            eps: float = 1e-8, weight_decay: float = 0.1,
            max_grad_norm: float = 1.0):
    """``update`` written into ``params`` and ``state``'s moments in place,
    as the reference's jitted train step, which donates them, has XLA
    write its new values into their buffers: each leaf's new values by
    ``update``'s arithmetic, one piece at a time, so no second tree is
    made, only one piece's temporaries.  ``stacked``: a tree of bools
    like ``params``, True where a leaf has a leading layer axis, whose
    pieces are then its layers; any other leaf is one piece.  DTensors
    (gradients, moments and parameters laid out alike) are updated on
    their local shards.  Returns (``params``, the new state with
    ``state``'s moments, gnorm)."""
    step = state.step + 1
    gnorm, scale, c1, c2 = _clip_and_bias(grads, step, b1, b2, max_grad_norm)
    local = lambda t: t.to_local() if hasattr(t, "to_local") else t  # noqa
    scale, c1, c2 = local(scale), local(c1), local(c2)
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)

    def write(g, m, v, p, rows):
        decay = p.ndim >= 2
        leaf = tuple(local(t) for t in (g, m, v, p))
        for gi, mi, vi, pi in (zip(*leaf) if rows else (leaf,)):
            new = _new_values(gi, mi, vi, pi, scale, c1, c2, decay=decay,
                              **kw)
            for dst, src in zip((pi, mi, vi), new):
                dst.copy_(src)
    if stacked is None:
        stacked = tree_map(lambda _: False, params)
    tree_map(write, grads, state.mu, state.nu, params, stacked)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), gnorm
