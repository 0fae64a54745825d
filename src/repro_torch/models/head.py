"""The LM head and its chunked cross-entropy.

Counterpart of ``head_matrix``, ``logits_last`` and ``chunked_ce_loss`` of
``repro.models.transformer``.  The reference computes the head as one
einsum on the model's own operands (bf16 in a bf16 model) with float32
accumulation and output (``preferred_element_type``), its gradients as
products of the float32 cotangent with those operands rounded back to
their dtype, and under a mesh its partitioner keeps the logits sharded on
the vocabulary where the head is.  Here:

* ``head_logits(h, w)``: that product, an autograd function
  (``_HeadProduct``).  On a 16-bit CUDA (or meta) operand pair it is
  ``torch.mm(..., out_dtype=torch.float32)``: no float32 copy of the head
  is made, and where the op cannot run it raises.  Its backward splits the
  float32 cotangent into a 16-bit high and low part and takes two 16-bit
  products with float32 output (``mixed_mm``), so it never widens the
  head either.  On the CPU, and for float32 operands, it is the plain
  widened product.
* ``chunked_ce_loss``: one autograd function per chunk of rows
  (``_ChunkCE``) that keeps only the rows, the head and each row's
  log-sum-exp, and recomputes the chunk's logits in its backward, as the
  reference's ``jax.checkpoint`` does.
* Under a mesh (DTensors) both work on each rank's local shards
  (``_local_parts``): the rows as the batch axes lay them out, the head's
  own vocabulary shard (sharded on 'model' where 'model' divides the
  vocabulary, ``distributed.sharding``).  The cross-entropy combines the
  ranks of the vocabulary's mesh dims with all-reduces of a row's max,
  sum of exponentials and gold logit; its backward gives each rank the
  softmax minus the one-hot on its own shard, a pending sum over those
  dims for the rows' gradient and the head's gradient laid out as the
  head's shard (a pending sum over the batch axes).  No rank holds logits
  or a head wider than its vocabulary shard; the logits are never
  redistributed.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import is_dtensor
from repro_torch.models import layers as L


def head_matrix(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"].T            # (d, V)
    return params["lm_head"]


# ---------------------------------------------------------------------------
# The product: 16-bit operands, float32 accumulation and result
# ---------------------------------------------------------------------------
def _split(t: torch.Tensor, dtype) -> tuple:
    """A float32 tensor as two ``dtype`` parts whose sum holds it to about
    twice ``dtype``'s mantissa bits."""
    hi = t.to(dtype)
    return hi, (t - hi).to(dtype)


@torch.library.custom_op("repro_torch::mixed_mm", mutates_args=())
def mixed_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D) in float32, one operand float32 and the other 16-bit,
    without widening the 16-bit one: the float32 operand split in two
    16-bit parts (``_split``), two 16-bit products with float32 output
    (``mm.dtype``, ``addmm.dtype``) summed into one result.  It is the
    reference's one product of a float32 and a 16-bit operand with
    float32 output (a ``dot_general``), and the op counter counts it as
    one product (``perf/op_analysis.py``), as XLA counts a dot however
    many passes its precision takes."""
    f32 = torch.float32
    if a.dtype == f32:
        hi, lo = _split(a, b.dtype)
        c = torch.mm(hi, b, out_dtype=f32)
        return torch.addmm(c, lo, b, out_dtype=f32, out=c)
    hi, lo = _split(b, a.dtype)
    c = torch.mm(a, hi, out_dtype=f32)
    return torch.addmm(c, a, lo, out_dtype=f32, out=c)


@mixed_mm.register_fake
def _(a, b):
    return a.new_empty((a.shape[0], b.shape[1]), dtype=torch.float32)


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D) in float32, each operand float32 or a 16-bit type.
    On the CPU, or where both are float32: the widened product.
    Elsewhere no 16-bit operand is widened: two 16-bit operands take one
    product with float32 output (``mm.dtype``), a float32 one facing a
    16-bit one ``mixed_mm``; raises where those products cannot run."""
    if a.device.type == "cpu" or (a.dtype == torch.float32
                                  and b.dtype == torch.float32):
        return a.float() @ b.float()
    if torch.float32 in (a.dtype, b.dtype):
        return mixed_mm(a, b)
    return torch.mm(a, b, out_dtype=torch.float32)


class _HeadProduct(torch.autograd.Function):
    """(n, d) x (d, V) -> (n, V) float32 (``_f32_product``); the gradients
    are the float32 cotangent's products with the other operand, rounded
    to each operand's dtype, as the reference's."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return _f32_product(h, w)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        return (_f32_product(g, w.T).to(h.dtype),
                _f32_product(h.T, g).to(w.dtype))


# ---------------------------------------------------------------------------
# Local shards of the head's operands under a mesh
# ---------------------------------------------------------------------------
class _Vocab:
    """This rank's part of the vocabulary: ``offset``, the id of its first
    entry, and ``groups``, the process groups of the mesh dims that shard
    it (none without a mesh)."""

    def __init__(self, offset: int = 0, groups: tuple = ()):
        self.offset, self.groups = offset, groups

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        for name in self.groups:
            t = torch.ops._c10d_functional.wait_tensor(
                torch.ops._c10d_functional.all_reduce(t, op, name))
        return t

    def index(self, ids: torch.Tensor, n: int) -> tuple:
        """(``ids`` as indices into this rank's ``n`` entries, clamped, and
        whether each lies among them)."""
        local = ids.long() - self.offset
        return local.clamp(0, n - 1), (local >= 0) & (local < n)


def _vocab(mesh, placements, dim: int, n_local: int) -> tuple:
    """(the mesh dims of more than one rank that shard a table's vocabulary
    dim ``dim``, and this rank's ``_Vocab``), the table holding
    ``n_local`` entries a rank."""
    from torch.distributed.tensor import Shard
    dims = [i for i, p in enumerate(placements)
            if p == Shard(dim) and mesh.size(i) > 1]
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return dims, _Vocab(idx * n_local, tuple(mesh.get_group(i).group_name
                                             for i in dims))


def _laid_out(t: torch.Tensor, mesh, placements, shape) -> torch.Tensor:
    """``t``, this rank's part, as a contiguous DTensor of the global
    ``shape``: ``from_local`` alone takes the global strides from the
    local ones, scaled, which on a dim of one element makes a layout
    that a later product cannot fold (it expands the weight instead)."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=shape, stride=torch.empty(
                                  shape, device="meta").stride())


def _local_parts(h, w, rows: tuple = ()):
    """The vocab-parallel layout of ``h`` (..., d) and the head ``w`` (d, V),
    as local tensors: (h's local rows, w's local shard, ``rows``' locals
    laid out as h's rows, the ``_Vocab``, a function laying a local
    result out).  On each mesh dim: where ``w`` shards its vocabulary,
    ``h`` is made whole there (a pending sum done); elsewhere ``w`` is
    made whole and ``h`` keeps a shard of a row dim, or is made whole.  ``h``'s local tensor takes its gradient as a pending sum over
    the vocabulary's dims, ``w``'s as its shard, a pending sum over the
    dims that shard ``h``'s rows.  The result laid out by ``place(t,
    'logits')`` keeps the rows as ``h`` and the vocabulary as ``w``;
    ``place(t, 'sum')``, a sum over the local rows, is a pending sum over
    the rows' dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    ref = w if is_dtensor(w) else h
    mesh = ref.device_mesh
    whole = (Replicate(),) * mesh.ndim
    if not is_dtensor(h):
        h = L.from_local(h, mesh, whole)
    if not is_dtensor(w):
        w = L.from_local(w, mesh, whole)
    vocab, voc = _vocab(mesh, w.placements, 1, w.to_local().shape[1])
    wp = tuple(p if i in vocab else Replicate()
               for i, p in enumerate(w.placements))
    hp = tuple(Replicate() if i in vocab or not (
        isinstance(p, Shard) and p.dim < h.ndim - 1) else p
        for i, p in enumerate(h.placements))
    if tuple(w.placements) != wp:
        w = w.redistribute(mesh, wp)
    if tuple(h.placements) != hp:
        h = h.redistribute(mesh, hp)
    row_dims = [i for i, p in enumerate(hp) if isinstance(p, Shard)]
    hl = h.to_local(grad_placements=tuple(
        Partial() if i in vocab else p for i, p in enumerate(hp)))
    wl = w.to_local(grad_placements=tuple(
        Partial() if i in row_dims else p for i, p in enumerate(wp)))
    locs = []
    for t in rows:
        if not is_dtensor(t):
            t = L.from_local(t, mesh, whole)
        locs.append((t if tuple(t.placements) == hp
                     else t.redistribute(mesh, hp)).to_local())
    out_pl = {"logits": tuple(Shard(h.ndim - 1) if i in vocab else p
                              for i, p in enumerate(hp)),
              "sum": tuple(Partial() if i in row_dims else Replicate()
                           for i in range(mesh.ndim))}
    shapes = {"logits": (*h.shape[:-1], w.shape[1]), "sum": ()}

    def place(t, kind):
        return _laid_out(t, mesh, out_pl[kind], shapes[kind])
    return hl, wl, locs, voc, place


def head_logits(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h`` (..., d) x the head ``w`` (d, V) -> (..., V) float32 logits
    (``_HeadProduct``).  DTensors: on each rank's local shards
    (``_local_parts``), the logits sharded on the vocabulary as ``w``."""
    if not (is_dtensor(h) or is_dtensor(w)):
        return _HeadProduct.apply(h.reshape(-1, h.shape[-1]), w).reshape(
            *h.shape[:-1], w.shape[-1])
    hl, wl, _, _, place = _local_parts(h, w)
    return place(head_logits(hl, wl), "logits")


def logits_last(params, h_last, cfg):
    """h_last: (B, d) -> (B, V) float32 logits (with final softcap)."""
    return L.softcap(head_logits(h_last, head_matrix(params, cfg)),
                     cfg.final_logit_softcap)


# ---------------------------------------------------------------------------
# The embedding lookup on the same table
# ---------------------------------------------------------------------------
class _Lookup(torch.autograd.Function):
    """``table[ids]`` on this rank's vocabulary shard ``table`` (V_loc, d):
    an id outside the shard gives a zero row, and the ranks of ``vocab``'s
    mesh dims sum their rows (an all-reduce).  The backward adds the rows'
    gradient into a zero gradient of the shard at the ids inside it."""

    @staticmethod
    def forward(ctx, table, ids, vocab):
        local, inside = vocab.index(ids, table.shape[0])
        rows = table[local]
        if vocab.groups:
            rows = vocab.all_reduce(rows.masked_fill(~inside[..., None], 0),
                                    "sum")
        ctx.save_for_backward(local, inside)
        ctx.shape = table.shape
        return rows

    @staticmethod
    def backward(ctx, g):
        local, inside = ctx.saved_tensors
        gt = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        gt.index_put_((local.reshape(-1),), g.masked_fill(
            ~inside[..., None], 0).reshape(-1, g.shape[-1]), accumulate=True)
        return gt, None, None


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (the token embedding, the tied head's own table).  A
    DTensor table: each rank looks its ids up in its own vocabulary shard
    (``_Lookup``), the table made whole on the other mesh dims and the
    ids on the vocabulary's; the rows are laid out as the ids, and the
    table's gradient as its shard, a pending sum over the dims that shard
    the ids.  No rank gathers the table's vocabulary."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    if not is_dtensor(ids):
        ids = L.from_local(ids, mesh, (Replicate(),) * mesh.ndim)
    dims, voc = _vocab(mesh, table.placements, 0, table.to_local().shape[0])
    tp = tuple(p if i in dims else Replicate()
               for i, p in enumerate(table.placements))
    ip = tuple(Replicate() if i in dims or not isinstance(p, Shard) else p
               for i, p in enumerate(ids.placements))
    if tuple(table.placements) != tp:
        table = table.redistribute(mesh, tp)
    if tuple(ids.placements) != ip:
        ids = ids.redistribute(mesh, ip)
    row_dims = [i for i, p in enumerate(ip) if isinstance(p, Shard)]
    tl = table.to_local(grad_placements=tuple(
        Partial() if i in row_dims else p for i, p in enumerate(tp)))
    return _laid_out(_Lookup.apply(tl, ids.to_local(), voc), mesh, ip,
                     (*ids.shape, table.shape[1]))


# ---------------------------------------------------------------------------
# The chunked cross-entropy
# ---------------------------------------------------------------------------
def _capped(z: torch.Tensor, cap: Optional[float], keep_tanh=False):
    """softcap(z), ``z`` overwritten; with ``keep_tanh``, (softcap(z),
    tanh(z / cap) or None)."""
    if cap is None:
        return (z, None) if keep_tanh else z
    t = z.div_(cap).tanh_()
    return (t * cap, t) if keep_tanh else t.mul_(cap)


class _ChunkCE(torch.autograd.Function):
    """sum over rows of ``(lse - gold) * mask`` for one chunk of rows ``h``
    (n, d) against the head's local shard ``w`` (d, V_loc): float32
    logits with the final softcap, the log-sum-exp and gold logit over
    the whole vocabulary (``vocab``'s all-reduces).  Saves the rows, the
    head and each row's log-sum-exp; the backward recomputes the logits
    and gives ``(softmax - onehot) * mask`` on the local shard through
    the softcap to both products (``_HeadProduct``'s rule)."""

    @staticmethod
    def forward(ctx, h, w, labels, mask, cap, vocab):
        logits = _capped(_f32_product(h, w), cap)
        m = vocab.all_reduce(logits.amax(-1), "max")
        s = vocab.all_reduce(
            (logits - m[:, None]).exp_().sum(-1), "sum")
        lse = m + s.log()
        idx, inside = vocab.index(labels, w.shape[1])
        gold = vocab.all_reduce(logits.gather(1, idx[:, None])[:, 0]
                                * inside, "sum")
        ctx.save_for_backward(h, w, labels, mask, lse)
        ctx.cap, ctx.vocab = cap, vocab
        return ((lse - gold) * mask).sum()

    @staticmethod
    def backward(ctx, g):
        h, w, labels, mask, lse = ctx.saved_tensors
        logits, t = _capped(_f32_product(h, w), ctx.cap, keep_tanh=True)
        dz = logits.sub_(lse[:, None]).exp_()              # softmax
        idx, inside = ctx.vocab.index(labels, w.shape[1])
        dz.scatter_add_(1, idx[:, None], -inside[:, None].float())
        dz.mul_((mask * g)[:, None])
        if t is not None:
            dz.mul_(t.square_().neg_().add_(1.0))
        return (_f32_product(dz, w.T).to(h.dtype),
                _f32_product(h.T, dz).to(w.dtype), None, None, None, None)


def chunked_ce_loss(params, h, labels, mask, cfg, chunk: int = 512):
    """Cross-entropy over (B, T) without materialising (B, T, V) logits:
    one ``_ChunkCE`` per ``chunk`` positions of each rank's own rows
    (padded to a whole chunk), divided by the mask's sum.  Under a mesh
    each rank takes its own rows against its own vocabulary shard
    (``_local_parts``)."""
    w = head_matrix(params, cfg)
    total = mask.sum().clamp_min(1.0)
    if is_dtensor(h) or is_dtensor(w):
        hl, wl, (ll, ml), vocab, place = _local_parts(h, w, (labels, mask))
    else:
        hl, wl, ll, ml, vocab, place = h, w, labels, mask, _Vocab(), None
    T, d = hl.shape[1], hl.shape[2]
    chunk = min(chunk, T)
    pad = (-T) % chunk
    if pad:
        hl = F.pad(hl, (0, 0, 0, pad))
        ll = F.pad(ll, (0, pad))
        ml = F.pad(ml, (0, pad))
    loss = sum(_ChunkCE.apply(hl[:, c:c + chunk].reshape(-1, d), wl,
                              ll[:, c:c + chunk].reshape(-1),
                              ml[:, c:c + chunk].reshape(-1).float(),
                              cfg.final_logit_softcap, vocab)
               for c in range(0, T + pad, chunk))
    if place is not None:
        loss = place(loss, "sum")
    return loss / total
