"""Flat-npz checkpoints of parameter and optimizer trees, the counterpart
of ``repro.training.checkpoint``: the same file under the same keys, so
either package loads what the other saved.

A key is the leaf's path as ``jax.tree_util`` names it: dict keys, list
indices and the optimizer state's field names joined by ``/``
(``params/groups/0/attn/wq``, ``opt/mu/...``, ``opt/nu/...``,
``opt/step``), plus ``__step__``.  bfloat16 leaves are saved as float32
(npz has no bfloat16), which is exact.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> dict:
    """{path: leaf} in the reference's key format."""
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):                      # a NamedTuple
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save(path: str, step: int, params: Any, opt_state: Any = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {f"params/{k}": _to_numpy(v)
               for k, v in _flatten(params).items()}
    if opt_state is not None:
        payload.update({f"opt/{k}": _to_numpy(v)
                        for k, v in _flatten(opt_state).items()})
    payload["__step__"] = np.asarray(step)
    np.savez(path, **payload)


def _restore(tree: Any, data, key: str):
    """``tree``'s structure with each leaf read from ``data[key/path]``, in
    the leaf's dtype and on its device."""
    if isinstance(tree, dict):
        return {k: _restore(v, data, f"{key}/{k}") for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_restore(v, data, f"{key}/{k}")
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_restore(v, data, f"{key}/{i}")
                          for i, v in enumerate(tree))
    return torch.from_numpy(np.array(data[key])).to(tree.device, tree.dtype)


def load(path: str, params_template: Any, opt_template: Any = None):
    """Restores into the structure, dtypes and devices of the templates.
    Returns (step, params, opt)."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        step = int(data["__step__"])
        params = _restore(params_template, data, "params")
        opt = (_restore(opt_template, data, "opt")
               if opt_template is not None else None)
    return step, params, opt
