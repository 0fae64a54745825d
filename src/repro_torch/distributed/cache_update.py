"""Sharded cache writes, the counterpart of
``repro.distributed.cache_update``.

A write at a traced position into a sequence axis sharded over the mesh
would make a partitioner gather the whole cache.  The reference appends
under ``shard_map``: each device checks whether the global slot lands in
its local shard and writes the one-token slice there.  Here each rank
computes its shard index on the cache's sequence axis from its mesh
coordinates (``DeviceMesh.get_local_rank``) and writes its local shard in
place, where the slot lands in it: O(token) traffic and zero collectives.
The placements come from the cache's DTensor itself, so the reference's
spec and mesh-info arguments are not needed.  On plain tensors (one
device) each write is a plain slice write.

``deltas_like`` puts a decode step's deltas in the cache's layout with
the sequence axis whole (the reference's ``shard_map`` input spec); the
decode step calls it, so any resharding of the new token's K/V is the
step's and ``apply_cache_deltas`` itself sends nothing.  ``write_slice``
is the prefill's write of positions ``[start, start + n)``.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import is_dtensor


def _seq_shard(c, axis: int) -> tuple:
    """(this rank's shard index, shard count) of DTensor ``c`` on ``axis``;
    several mesh dims sharding one axis split it in mesh order."""
    mesh = c.device_mesh
    idx, total = 0, 1
    for i, p in enumerate(c.placements):
        if p.is_shard(axis):
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
            total *= mesh.size(i)
    return idx, total


def _layout(c, axis) -> tuple:
    """``c``'s placements with ``axis`` (None: no axis) whole."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if axis is not None and p.is_shard(axis) else p
                 for p in c.placements)


def _local_like(c, d, axis):
    """``d``'s local shard, laid out as ``c`` with ``axis`` whole (a plain
    ``d`` counts as replicated)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = c.device_mesh
    if not is_dtensor(d):
        d = DTensor.from_local(d, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    want = _layout(c, axis)
    if tuple(d.placements) != want:
        d = d.redistribute(mesh, want)
    return d.to_local()


def deltas_like(deltas, cache, axis_of=lambda c: c.ndim - 2):
    """Each delta leaf in its cache leaf's layout, with the sequence axis
    (``axis_of``; none for a state leaf of the cache's shape) whole.
    Plain leaves are returned as they are."""
    if isinstance(deltas, dict):
        return {k: deltas_like(v, cache[k], axis_of)
                for k, v in deltas.items()}
    if isinstance(deltas, list):
        return [deltas_like(d, c, axis_of) for d, c in zip(deltas, cache)]
    d, c = deltas, cache
    if d is c or not is_dtensor(c):
        return d
    from torch.distributed.tensor import DTensor
    axis = None if d.shape == c.shape else axis_of(c)
    loc = _local_like(c, d, axis)
    return DTensor.from_local(loc, c.device_mesh, _layout(c, axis),
                              run_check=False)


def append_kv(cache_leaf, delta_leaf, pos, axis: int = 3):
    """Write ``delta_leaf`` (the cache's shape with 1 on ``axis``) into
    ``cache_leaf`` at slot ``pos % capacity`` along ``axis``, in place;
    returns the cache leaf.  ``pos``: 0-d int tensor (never read on the
    host)."""
    if is_dtensor(pos):
        pos = pos.to_local()
    if not is_dtensor(cache_leaf):
        slot = (pos % cache_leaf.shape[axis]).reshape(1).long()
        cache_leaf.index_copy_(axis, slot,
                               delta_leaf.to(cache_leaf.dtype))
        return cache_leaf
    idx, total = _seq_shard(cache_leaf, axis)
    c_loc = cache_leaf.to_local()
    d_loc = _local_like(cache_leaf, delta_leaf, axis).to(c_loc.dtype)
    s_loc = c_loc.shape[axis]
    slot = pos % (s_loc * total)
    start = idx * s_loc
    local = (slot - start).clamp(0, s_loc - 1).reshape(1).long()
    in_range = (slot >= start) & (slot < start + s_loc)
    cur = c_loc.index_select(axis, local)
    c_loc.index_copy_(axis, local, torch.where(in_range, d_loc, cur))
    return cache_leaf


def write_whole(c, d) -> None:
    """``c`` = ``d`` in place (each rank its own shard of a DTensor)."""
    if is_dtensor(c):
        c.to_local().copy_(_local_like(c, d, None))
    else:
        c.copy_(d)


def apply_cache_deltas(cache, deltas, pos):
    """Walk the cache tree: K/V leaves (sequence axis -2) get the sharded
    append; state leaves (the delta's shape) are overwritten whole; a
    delta that is its cache leaf (cross-attention K/V) is left alone.
    Writes in place and returns the cache."""
    if isinstance(cache, dict):
        for k in cache:
            apply_cache_deltas(cache[k], deltas[k], pos)
        return cache
    if isinstance(cache, list):
        for c, d in zip(cache, deltas):
            apply_cache_deltas(c, d, pos)
        return cache
    if deltas is cache:
        return cache
    if cache.shape == deltas.shape:
        write_whole(cache, deltas)
    else:
        append_kv(cache, deltas, pos, axis=cache.ndim - 2)
    return cache


def write_slice(buf, value, dim: int, start: int) -> None:
    """``buf`` along ``dim`` at ``[start, start + n)`` = ``value`` (n its
    size on ``dim``), in place.  A DTensor ``buf`` writes into each
    rank's local shard the part of the range that lands in it."""
    n = value.shape[dim]
    if not is_dtensor(buf):
        buf.narrow(dim, start, n).copy_(value)
        return
    loc = buf.to_local()
    val = _local_like(buf, value, dim)
    idx, _ = _seq_shard(buf, dim)
    s_loc = loc.shape[dim]
    lo = idx * s_loc
    a, b = max(start, lo), min(start + n, lo + s_loc)
    if a < b:
        loc.narrow(dim, a - lo, b - a).copy_(val.narrow(dim, a - start, b - a))
