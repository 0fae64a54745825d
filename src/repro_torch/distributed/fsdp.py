"""FSDP's per-layer gather: the sharded steps' parameters made whole on the
batch axes ('pod', 'data') one layer at a time, as the model reaches the
layer, and each layer's gradient taken back onto the parameters' shards as
the backward leaves the layer.

The reference's compiled step does this inside its layer scan (XLA's
partitioner all-gathers an FSDP-sharded weight where the scan body uses
it and reduce-scatters its gradient there).  Here the model applies
``gathered`` to each layer's slice of its stacked leaves inside the layer
body, so that under ``torch.utils.checkpoint`` the backward gathers the
layer again and a rank holds one gathered layer at a time.  The gather is
an autograd function (``_Gathered``) whose backward lays the gradient out
as the shard was: a pending sum over the batch axes (a weight used on
batch-sharded activations) becomes a reduce-scatter onto the shard.

A stacked leaf whose layer axis the FSDP rule shards (it picks the
largest divisible dim, which may be the layer axis of a small leaf) is
never gathered whole: its layer ``i`` is taken from the rank that holds
it (``_OwnedLayer``), the other ranks contributing zeros to one
all-reduce of that layer.  ``layers`` hands such a leaf's layers out as
``LayerRef``s, taken only when ``resolved`` or ``gathered`` reaches them,
inside the layer body.

Plain tensors pass through untouched.  DTensor is imported only where a
DTensor is met, so a plain program never imports it.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import is_dtensor


class LayerRef:
    """Layer ``i`` of a stacked DTensor leaf whose layer axis is sharded,
    not yet taken (``resolved`` takes it)."""

    __slots__ = ("leaf", "i")

    def __init__(self, leaf, i: int):
        self.leaf, self.i = leaf, i


def _shards_layer_axis(t) -> bool:
    """Does a mesh dim of more than one rank shard DTensor ``t``'s dim 0?"""
    return any(p.is_shard(0) and n > 1
               for p, n in zip(t.placements, t.device_mesh.shape))


def _shifted(p):
    """A placement of a leaf as that of its layer slices (dim 0 gone)."""
    from torch.distributed.tensor import Shard
    return Shard(p.dim - 1) if type(p) is Shard else p


class _OwnedLayer(torch.autograd.Function):
    """Layer ``i`` of a DTensor leaf sharded on its layer axis, whole on the
    mesh dims that shard that axis and laid out as the leaf on the others:
    the rank holding the layer gives its local slice, every other rank
    zeros, and one all-reduce (a pending sum made whole) puts it on every
    rank.  No rank holds more than this one layer of the leaf.  The
    backward gives the leaf's gradient on the holder's local slice, zero
    elsewhere, after making the layer's gradient whole."""

    @staticmethod
    def forward(ctx, leaf, i: int):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        mesh, n, j, mine = leaf.device_mesh, leaf.shape[0], i, True
        for d, p in enumerate(leaf.placements):
            if p.is_shard(0) and mesh.size(d) > 1:
                n //= mesh.size(d)
                mine = mine and mesh.get_local_rank(d) == j // n
                j %= n
        local = leaf.to_local()
        piece = local[j] if mine else torch.zeros_like(local[j])
        pending = tuple(Partial() if p.is_shard(0) else _shifted(p)
                        for p in leaf.placements)
        whole = tuple(Replicate() if p.is_partial() else p for p in pending)
        ctx.leaf_placements, ctx.whole = leaf.placements, whole
        ctx.local_shape, ctx.j, ctx.mine = local.shape, j, mine
        return DTensor.from_local(piece, mesh, pending,
                                  run_check=False).redistribute(mesh, whole)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor
        if tuple(g.placements) != ctx.whole:
            g = g.redistribute(g.device_mesh, ctx.whole)
        gl = g.to_local()
        out = torch.zeros(ctx.local_shape, dtype=gl.dtype, device=gl.device)
        if ctx.mine:
            out[ctx.j] = gl
        return DTensor.from_local(out, g.device_mesh, ctx.leaf_placements,
                                  run_check=False), None


class _Gathered(torch.autograd.Function):
    """A DTensor redistributed to ``want`` whose backward lays the gradient
    out as the input was: a pending sum onto a shard is a reduce-scatter,
    onto a replica an all-reduce."""

    @staticmethod
    def forward(ctx, t, want):
        ctx.placements = tuple(t.placements)
        if tuple(want) == ctx.placements:
            return t.view_as(t)
        return t.redistribute(t.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def layer(t, i: int):
    """Layer ``i`` of a stacked leaf: ``t[i]``; of a DTensor sharded on its
    layer axis, that layer taken from the rank holding it
    (``_OwnedLayer``)."""
    if is_dtensor(t) and _shards_layer_axis(t):
        return _OwnedLayer.apply(t, i)
    return t[i]


def layers(t) -> tuple:
    """Every layer of a stacked leaf: ``t.unbind(0)`` (whose backward stacks
    the layers' gradients into the leaf once); of a DTensor sharded on its
    layer axis, a ``LayerRef`` per layer."""
    if is_dtensor(t) and _shards_layer_axis(t):
        return tuple(LayerRef(t, i) for i in range(t.shape[0]))
    return t.unbind(0)


def resolved(tree):
    """A dict tree with each ``LayerRef`` taken (``layer``)."""
    if isinstance(tree, dict):
        return {k: resolved(v) for k, v in tree.items()}
    if isinstance(tree, LayerRef):
        return _OwnedLayer.apply(tree.leaf, tree.i)
    return tree


def gathered(tree, batch_axes: tuple):
    """A dict tree of one layer's (or the leaves outside the layer groups')
    parameters with every DTensor made whole on the mesh axes
    ``batch_axes``, the others' placements kept (the 'model' axis's TP);
    ``LayerRef``s taken first.  Where a leaf already is whole there, the
    result still passes its gradient through ``_Gathered``, which makes a
    pending sum over those axes whole once per layer."""
    if isinstance(tree, dict):
        return {k: gathered(v, batch_axes) for k, v in tree.items()}
    t = resolved(tree)
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    names = t.device_mesh.mesh_dim_names
    want = tuple(Replicate() if names[d] in batch_axes else p
                 for d, p in enumerate(t.placements))
    if want == tuple(t.placements) and not (t.requires_grad
                                            and torch.is_grad_enabled()):
        return t
    return _Gathered.apply(t, want)
