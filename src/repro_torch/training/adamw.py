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


@torch.no_grad()
def update(grads, state: AdamWState, params, *, lr: float = 3e-4,
           b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
           weight_decay: float = 0.1, max_grad_norm: float = 1.0):
    """Returns (new_params, new_state, gnorm): the gradients clipped to a
    global norm of ``max_grad_norm``, decay only on leaves of two or more
    dimensions, each new leaf cast back to its parameter's dtype."""
    step = state.step + 1
    gnorm = torch.sqrt(sum(g.float().square().sum()
                           for g in tree_leaves(grads)))
    scale = torch.clamp(max_grad_norm / gnorm.clamp_min(1e-9), max=1.0)
    t = step.float()
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t

    def upd(g, m, v, p):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g.square()
        dp = (m / c1) / (torch.sqrt(v / c2) + eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            dp = dp + weight_decay * p.float()
        return (p.float() - lr * dp).to(p.dtype), m, v

    out = tree_map(upd, grads, state.mu, state.nu, params)
    pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
    return pick(0), AdamWState(step=step, mu=pick(1), nu=pick(2)), gnorm
