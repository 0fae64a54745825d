"""Divisibility-aware sharding rules for params, inputs and caches.

Counterpart of ``repro.distributed.sharding``: the same rules, entry for
entry, over a ``torch.distributed`` ``DeviceMesh`` instead of a JAX mesh.

Mesh axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
multi-pod.  Strategy (the reference's baseline):

Params
  * TP over 'model':
      - attention: head axis, only when the KV-head count divides the model
        axis (whisper, zamba2) or KV==1 with Q-heads divisible (granite MQA);
        with q-TP (the default) the Q/O projections also shard when only
        the Q-head count divides it.
      - MLP: d_ff axis.
      - MoE: expert axis when divisible (qwen3: 128/16), else per-expert d_ff
        (mixtral: 8 experts, 16384 d_ff).
      - embeddings / lm_head: vocab axis when divisible.
      - Mamba blocks: replicated over 'model', sharded over 'data' in train
        mode.
  * FSDP over 'data' (train mode, and inference when the TP-sharded params
    exceed ``HBM_PARAM_BUDGET``): largest remaining divisible axis.
  * 'pod' replicates params (DP across pods, FSDP within a pod).

Inputs / caches
  * batch axes over ('pod','data') when divisible, else ('data',), else
    replicated.
  * decode KV caches: batch over 'data', sequence over 'model'; long_500k
    (batch=1) shards the sequence over every available axis.

A spec is a tuple with one entry per dim, each ``None``, an axis name or
a tuple of axis names: the entries of the reference's ``PartitionSpec``.
``to_placements`` turns one into DTensor placements (an axis pair such as
``("pod", "data")`` on one dim is ``Shard(dim)`` on both mesh dims, in
mesh order, which splits the dim as the pair does in JAX);
``distribute_tree`` lays a full tree out on the mesh, each rank keeping
its own slice, with no communication.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs.base import ModelConfig

# Per-device byte budget above which inference params get FSDP too.  The
# reference's value, derived for its TPU's HBM; kept so the placements stay
# equal to the reference's (a budget for the card's 80 GB would be a rule
# the reference does not have).
HBM_PARAM_BUDGET = 8 * 1024 ** 3


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    mesh: object            # torch.distributed.device_mesh.DeviceMesh

    @property
    def axis_sizes(self) -> dict:
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))

    @property
    def model(self) -> int:
        return self.axis_sizes.get("model", 1)

    @property
    def data(self) -> int:
        return self.axis_sizes.get("data", 1)

    @property
    def has_pod(self) -> bool:
        return "pod" in self.axis_sizes

    @property
    def batch_axes(self) -> tuple:
        return ("pod", "data") if self.has_pod else ("data",)

    @property
    def batch_size(self) -> int:
        return int(math.prod(self.axis_sizes[a] for a in self.batch_axes))


def attn_head_tp(cfg: ModelConfig, model: int) -> bool:
    """Can attention shard its head axes over the model axis?"""
    if cfg.num_kv_heads and _div(cfg.num_kv_heads, model):
        return True
    if cfg.num_kv_heads == 1 and _div(cfg.num_heads, model):
        return True  # MQA: H -> (1, G) reshape keeps shards aligned
    return False


def batch_spec_axes(minfo: MeshInfo, batch: int):
    """Largest prefix of batch axes that divides `batch`."""
    axes = []
    prod = 1
    for a in minfo.batch_axes:
        if _div(batch, prod * minfo.axis_sizes[a]):
            axes.append(a)
            prod *= minfo.axis_sizes[a]
    return tuple(axes) if axes else None


# ---------------------------------------------------------------------------
# Trees with paths (dicts and lists, as the port's params and caches)
# ---------------------------------------------------------------------------
def _path_names(path) -> list:
    """The names ``jax.tree_util`` gives a leaf's path: dict keys as
    strings, list indices as ``[i]``."""
    return [f"[{k}]" if isinstance(k, int) else str(k) for k in path]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, lists and named tuples (the
    optimizer's state; any other tuple is a leaf: a spec, a placement
    tuple), keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    return fn(path, tree)


def tree_map2(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of one structure."""
    return tree_map_with_path(
        lambda path, leaf: fn(leaf, _at(other, path)), tree)


def _at(tree, path):
    for k in path:
        tree = getattr(tree, k) if _is_namedtuple(tree) else tree[k]
    return tree


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------
def _fsdp_axis(shape: tuple, taken: dict, data: int) -> Optional[int]:
    """Largest dim divisible by `data` not already sharded."""
    best, best_dim = None, 0
    for i, s in enumerate(shape):
        if i in taken:
            continue
        if _div(s, data) and s > best_dim:
            best, best_dim = i, s
    return best


def _leaf_spec(path_names: list, shape: tuple, cfg: ModelConfig,
               minfo: MeshInfo, fsdp: bool, q_tp: bool = False) -> tuple:
    model, data = minfo.model, minfo.data
    name = path_names[-1] if path_names else ""
    parents = set(path_names)
    nd = len(shape)
    tp: dict[int, str] = {}

    def last_dims(k):  # index of k-th dim from the end
        return nd - k

    in_moe = "moe" in parents
    in_attn = ("attn" in parents) or ("cross" in parents)
    in_mlp = "mlp" in parents

    if name in ("wq", "wk", "wv", "wo", "bq", "bk", "bv") and in_attn:
        head_tp = attn_head_tp(cfg, model)
        # q_tp: shard Q/O projections on the Q-head axis whenever H divides
        # the model axis, even if the KV heads don't (K/V weights stay
        # replicated — they are G times smaller).
        q_only = q_tp and not head_tp and _div(cfg.num_heads, model)
        if head_tp or q_only:
            if name in ("wq", "bq"):
                tp[last_dims(2)] = "model"      # (…, d, H, hd) -> H
            elif name in ("wk", "wv", "bk", "bv"):
                # MQA (KV=1) / q-only: K/V stay replicated
                if _div(cfg.num_kv_heads, model):
                    tp[last_dims(2)] = "model"
            else:  # wo: (…, H, hd, d)
                tp[last_dims(3)] = "model"
    elif name in ("wi", "wg") and in_moe:
        # MoE expert weights (…, E, d, f): EP when divisible, else TP on f
        if _div(cfg.num_experts, model):
            tp[last_dims(3)] = "model"
        elif _div(shape[-1], model):
            tp[last_dims(1)] = "model"
    elif name == "wo" and in_moe:
        # (…, E, f, d)
        if _div(cfg.num_experts, model):
            tp[last_dims(3)] = "model"
        elif _div(shape[last_dims(2)], model):
            tp[last_dims(2)] = "model"
    elif name in ("wi", "wg") and in_mlp:
        if _div(shape[-1], model):
            tp[last_dims(1)] = "model"          # dense MLP (…, d, f) -> f
    elif name == "wo" and in_mlp:
        # dense MLP down-proj (…, f, d)
        if _div(shape[last_dims(2)], model):
            tp[last_dims(2)] = "model"
    elif name == "router":
        pass                                     # (…, d, E) small, replicate
    elif name == "embed":
        # vocab-axis TP only; a non-divisible vocab is replicated over
        # 'model' (FSDP over 'data' still applies in train mode)
        if _div(cfg.vocab_size, model):
            tp[last_dims(2)] = "model"
    elif name == "lm_head":
        if _div(cfg.vocab_size, model):
            tp[last_dims(1)] = "model"
    elif name == "vis_proj":
        if _div(shape[-1], model):
            tp[last_dims(1)] = "model"

    spec = [None] * nd
    for i, ax in tp.items():
        spec[i] = ax
    if fsdp:
        fi = _fsdp_axis(shape, tp, data)
        if fi is not None:
            spec[fi] = "data"
    return tuple(spec)


def resolved_mode(cfg: ModelConfig, minfo: MeshInfo, mode: str) -> str:
    """``mode`` with 'infer' made 'train' (FSDP + TP) when the TP-sharded
    params exceed ``HBM_PARAM_BUDGET``, else 'tp': the one choice of
    ``param_specs`` that depends on the model's size."""
    if not mode.startswith("infer"):
        return mode
    fsdp = cfg.param_count() * 2 / minfo.model > HBM_PARAM_BUDGET
    return ("train" if fsdp else "tp") + mode[len("infer"):]


def param_specs(abstract_params, cfg: ModelConfig, minfo: MeshInfo,
                mode: str):
    """Spec tree for the params.
    mode: 'train' (FSDP+TP) | 'infer' (TP, +FSDP if over HBM budget) |
    'tp' (TP only — no per-layer all-gathers).  q-TP is on by default; a
    '_noqtp' suffix gives the baseline sharding without it."""
    q_tp = not mode.endswith("_noqtp")
    base = resolved_mode(cfg, minfo, mode).replace("_qtp", "").replace(
        "_noqtp", "")
    fsdp = base == "train"
    return tree_map_with_path(
        lambda path, leaf: _leaf_spec(_path_names(path), tuple(leaf.shape),
                                      cfg, minfo, fsdp, q_tp=q_tp),
        abstract_params)


# ---------------------------------------------------------------------------
# Input / cache rules
# ---------------------------------------------------------------------------
def batch_input_specs(abstract_batch: dict, minfo: MeshInfo) -> dict:
    out = {}
    for name, leaf in abstract_batch.items():
        axes = batch_spec_axes(minfo, leaf.shape[0])
        out[name] = (axes,) + (None,) * (leaf.ndim - 1)
    return out


def _cache_leaf_spec(path_names: list, shape: tuple, cfg: ModelConfig,
                     minfo: MeshInfo, batch: int, capacity: int) -> tuple:
    """KV caches: (count, B, KV, S, hd) [+ local/global/cross variants];
    mamba states: ssm (count[, inner], B, H, P, N), conv (…, B, W-1, C)."""
    name = path_names[-1] if path_names else ""
    nd = len(shape)
    b_axes = batch_spec_axes(minfo, batch)
    seq_axes: Optional[tuple]
    if batch == 1:
        # long-context: spend every axis on the sequence
        all_axes = (*minfo.batch_axes, "model")
        total = int(math.prod(minfo.axis_sizes[a] for a in all_axes))
        if _div(capacity, total):
            seq_axes = all_axes
        else:
            seq_axes = ("model",) if _div(capacity, minfo.model) else None
        b_axes = None
    else:
        seq_axes = ("model",) if _div(capacity, minfo.model) else None

    spec = [None] * nd
    if name in ("k", "v"):
        # (count, B, KV, S, hd)
        spec[nd - 4] = b_axes
        spec[nd - 2] = seq_axes
    elif name in ("ck", "cv"):
        # cross K/V (count, B, S_enc, KV, hd): encoder length small, batch
        # only
        spec[nd - 4] = b_axes
    elif name == "ssm":
        # (count[, inner], B, H, P, N)
        spec[nd - 4] = b_axes
    elif name == "conv":
        spec[nd - 3] = b_axes
    return tuple(spec)


def cache_specs_tree(abstract_cache, cfg: ModelConfig, minfo: MeshInfo,
                     batch: int, capacity: int):
    return tree_map_with_path(
        lambda path, leaf: _cache_leaf_spec(_path_names(path),
                                            tuple(leaf.shape), cfg, minfo,
                                            batch, capacity),
        abstract_cache)


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------
def axes_of(entry) -> tuple:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: tuple, mesh) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` where the spec names that
    mesh axis on dim d, else ``Replicate()``.  An axis of one rank shards
    nothing, so it is ``Replicate()`` (as a size-1 axis is to JAX): DTensor
    would otherwise refuse a view that folds a sharded size-1 dim."""
    dim_of = {}
    for d, entry in enumerate(spec):
        for a in axes_of(entry):
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of and n > 1 else Replicate()
                 for a, n in zip(mesh.mesh_dim_names, mesh.shape))


def _is_spec(x) -> bool:
    return isinstance(x, tuple)


def to_shardings(spec_tree, minfo: MeshInfo):
    """A spec tree as a tree of placements (tuples, leaves of the tree)."""
    if _is_spec(spec_tree):
        return to_placements(spec_tree, minfo.mesh)
    return tree_map_with_path(
        lambda _, s: to_placements(s, minfo.mesh), spec_tree)


def param_shardings(abstract_params, cfg, minfo: MeshInfo, mode: str):
    return to_shardings(param_specs(abstract_params, cfg, minfo, mode), minfo)


def distribute(t: torch.Tensor, placements: tuple, minfo: MeshInfo):
    """One full tensor (every rank holds the same) as a DTensor of these
    placements: each rank keeps its own slice, nothing is sent."""
    if isinstance(t, DTensor):
        return t.redistribute(minfo.mesh, placements)
    return distribute_tensor(t, minfo.mesh, placements, src_data_rank=None)


def distribute_tree(tree, shardings, minfo: MeshInfo):
    """``distribute`` over a tree and its tree of placements."""
    return tree_map2(lambda t, pl: distribute(t, pl, minfo), tree, shardings)


def zeros(abstract, shardings, minfo: MeshInfo, device):
    """Zeros of each abstract leaf's shape and dtype, laid out by its
    placements: each rank allocates only its own shard."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    def make(t, pl):
        shape, _ = compute_local_shape_and_global_offset(t.shape, minfo.mesh,
                                                         pl)
        return DTensor.from_local(
            torch.zeros(shape, dtype=t.dtype, device=device), minfo.mesh, pl,
            run_check=False)
    return tree_map2(make, abstract, shardings)


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in a tree."""
    total = 0

    def add(_, t):
        nonlocal total
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if isinstance(t, DTensor) else t
            total += loc.numel() * loc.element_size()
    tree_map_with_path(add, tree)
    return total
