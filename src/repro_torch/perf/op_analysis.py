"""Static analysis of a PyTorch program: FLOPs, device-memory traffic and
the op-class histogram of the program, counted as XLA counts its own.

Counterpart of ``repro.perf.hlo_analysis``, which reads the text of a
lowered XLA module.  The port never produces one, so ``analyze_ops(fn,
*args)`` runs ``fn`` on meta tensors (shapes and dtypes, no storage, no
arithmetic) under a ``TorchDispatchMode`` and counts each aten op as it is
dispatched.  It returns ``analyze_hlo``'s keys:

  * flops: 2 * prod(output dims) * (contracted dim) per dense product
    (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ...), as the reference counts
    a ``dot``; a convolution counts 2 * prod(output dims) * (input
    channels per group) * prod(kernel dims);
  * hbm_bytes: operand and result bytes of every op that is not a view
    (a view moves nothing), each tensor at its own dtype's size;
  * coll_bytes / coll_count, total_coll_bytes: each collective a
    DTensor program dispatches, by kind, at the reference's ring factors
    (``hlo_analysis``): all-gather 1 x result, all-reduce 2 x result,
    reduce-scatter 1 x operand, all-to-all and collective-permute 1 x
    result (a plain program has none);
  * n_ops and op_hist, the op-class mix over ``OP_CLASSES``, the cost
    model's fingerprint (``perf/cost_model.py``);
  * warnings: ops counted as ``elementwise`` only because no class names
    them (the reference's least-wrong bucket for an unknown opcode).

The cost model reads the fingerprint through a regressor trained on
far smaller nets, which moves ``host_ms`` by about 15% for each 0.01 of
share moved between ``elementwise`` and ``reshuffle``; so each aten op is
counted as the HLO ops JAX lowers the same array operation to (``_lower``),
classed as ``hlo_analysis._op_class`` classes HLO opcodes: ``dot`` to
``dense``, ``convolution`` to ``conv`` (``depthwise`` with more than one
group), ``while`` to ``rnn``, arithmetic, comparisons, ``select``,
reductions and ``convert`` to ``elementwise``, and ``reshape``,
``transpose``, ``broadcast``, slices, concatenation, gathers, scatters,
``iota``, ``sort`` and ``pad`` to ``reshuffle``.  What that adds to a
one-to-one count:

  * implicit broadcasting: PyTorch broadcasts inside an elementwise op,
    XLA emits the broadcast: a Python scalar or a 0-d operand is one
    ``broadcast`` (a scalar once per shape per loop iteration, as JAX
    shares a computation's constants); an operand of lower rank is first
    reshaped to the output's rank; one whose size-1 dims expand is
    ``broadcast``, ``reshape``, ``broadcast``; an unsqueezed operand
    broadcasts from its own shape, as JAX composes ``x[..., None]`` into
    the consumer's broadcast;
  * implicit promotion: an operand of another floating dtype than the op
    computes in is one ``convert`` (integers are all 32-bit to JAX, so
    int64 against int32 converts nothing);
  * a reduction is a ``reduce`` plus its reducer (``add``, ``maximum``,
    ...), a kept dim one ``reshape``, a mean one ``divide`` by a broadcast
    count, and a 16-bit sum or mean two ``convert``s;
  * composites are counted by their decomposition: ``silu``, ``softplus``,
    ``gelu``, ``softmax``, ``cumsum``, ``tril``, padding;
  * ``einsum`` and ``matmul`` are one ``dot`` per contraction (plus a
    ``transpose`` where the requested order is not the product's), as
    ``jnp.einsum`` lowers them, not the permutes, views and copies that
    ATen decomposes them into: a ``TorchFunctionMode`` counts the call and
    mutes what it dispatches (whose FLOPs still count).  A reshape that
    only regroups a product's operand or result is the dot's own
    dimension numbers, and operands all cast up to float32 for it are
    its ``preferred_element_type``: neither counts;
  * loops: the port unrolls in Python the loops the reference scans, so
    an integer index into a stacked axis stands for a scan iteration
    (``_OpCounter._loop_index``): the loop's ``while``, counter and
    condition, and, over a non-leading axis, the scanned block number and
    the index normalized as ``jnp`` indexes by a traced integer; a
    ``stack`` of per-iteration results is a mapped loop's output, one
    ``dynamic-update-slice`` each; an index that only addresses an
    in-place write is the write's own;
  * layout ops have no counterpart: ``clone`` / ``contiguous``, a view
    to the shape a tensor already has, and a transpose that moves only
    size-1 dims (a ``reshape``) count no more than JAX emits;
  * ``arange`` is an ``iota`` (plus an offset), or a constant when its
    step is not 1;
  * dead code: an op no result and no in-place write depends on is
    dropped, as JAX drops it before it lowers (the MoE layer's auxiliary
    loss, which the served step discards).

On DTensors (a program laid out on a ``DeviceMesh``, ``launch/steps.py``)
the count is one rank's program: the counter declines each DTensor op
(returns ``NotImplemented``), so DTensor dispatches it and the ops it
runs on the rank's local shards, and the collectives of its
redistributions, come back through the counter at their local shapes;
the ops DTensor runs to propagate global shapes and layouts (on fake
tensors, or through an op's decomposition on meta tensors the first time
it meets the op at a layout: ``dtensor_propagation_marked``), and those
it runs on host tensors to lay its meshes out (once a process), are not
counted.  Such a count has FLOPs, bytes and collectives only: ``n_ops``
and ``op_hist`` (the cost model's fingerprint of a whole program) are
None.  A mesh of host devices makes DTensor take an all-gather and a
chunk where a CUDA mesh takes an all-to-all (gloo has none), and that is
what the count sees.

Known difference: what remains is the code each package writes its own
way (the SSM chunk loop slices where the reference scans); over the 20
served modules at full width the histogram is within 0.022 of the
reference's and the op count within 0.98-1.06x of it.  ``n_computations``
has no counterpart and is not returned.
"""

from __future__ import annotations

import contextlib
import math
from collections import Counter
from typing import Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.distributed import is_dtensor

OP_CLASSES = ("conv", "depthwise", "dense", "rnn", "elementwise",
              "reshuffle")
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# the HLO opcodes ``repro.perf.hlo_analysis`` classes as reshuffles; but
# ``dot``, ``while`` and convolutions every other opcode counts as
# elementwise, named or not (``topk``, ``is-finite``, ``cosine``, ...)
_HLO_RESHUFFLE = {
    "reshape", "transpose", "broadcast", "concatenate", "slice",
    "dynamic-slice", "dynamic-update-slice", "pad", "gather", "scatter",
    "copy", "reverse", "iota", "sort",
}

# aten ops computed elementwise -> the HLO opcode of the same operation
_ELEMENTWISE_OPS = {
    "add": "add", "sub": "subtract", "rsub": "subtract",
    "mul": "multiply", "div": "divide", "neg": "negate", "abs": "abs",
    "sign": "sign", "exp": "exponential", "expm1": "exponential-minus-one",
    "log": "log", "log1p": "log-plus-one", "sqrt": "sqrt", "rsqrt": "rsqrt",
    "tanh": "tanh", "sigmoid": "logistic", "maximum": "maximum",
    "minimum": "minimum", "floor": "floor", "ceil": "ceil",
    "round": "round-nearest-even", "cos": "cosine", "sin": "sine",
    "reciprocal": "divide", "erf": "erf", "remainder": "remainder",
    "fmod": "remainder", "eq": "compare", "ne": "compare", "lt": "compare",
    "le": "compare", "gt": "compare", "ge": "compare",
    "logical_and": "and", "bitwise_and": "and", "logical_or": "or",
    "bitwise_or": "or", "logical_xor": "xor", "bitwise_xor": "xor",
    "logical_not": "not", "bitwise_not": "not", "where": "select",
    "masked_fill": "select", "clamp_min": "maximum",
    "clamp_max": "minimum", "isfinite": "is-finite",
}
_COMPARISONS = {"eq", "ne", "lt", "le", "gt", "ge", "logical_and",
                "bitwise_and", "logical_or", "bitwise_or", "logical_xor",
                "bitwise_xor", "logical_not", "bitwise_not"}
# reductions -> the reducer's opcode
_REDUCTIONS = {"sum": "add", "mean": "add", "amax": "maximum",
               "amin": "minimum", "max": "maximum", "min": "minimum",
               "prod": "multiply", "any": "or", "all": "and"}
# ``mixed_mm``: ``models/head.py``'s float32 x 16-bit product, the
# reference's one dot_general (two 16-bit passes on the card)
_DENSE_OPS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv",
              "dot", "vdot", "mixed_mm"}
_CONV_OPS = {"convolution", "_convolution"}
_RESHAPES = {"view", "_unsafe_view", "reshape", "_reshape_alias",
             "unsqueeze", "squeeze", "flatten", "unflatten", "view_as",
             "view_as_real", "view_as_complex"}
_TRANSPOSES = {"permute", "transpose", "t", "movedim", "numpy_T", "mT"}
_FILLS = {"full", "full_like", "zeros", "zeros_like", "ones", "ones_like",
          "new_zeros", "new_ones", "new_full", "fill", "zero",
          "scalar_tensor"}
_SPLITS = {"split", "split_with_sizes", "chunk", "tensor_split"}
_UNCLASSED_OPS = {
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "detach", "alias", "lift_fresh", "lift_fresh_copy",
    "_local_scalar_dense", "resize", "set", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "dim", "is_same_size",
    "_has_compatible_shallow_copy_type", "clone", "contiguous",
}
# composites, as jax.nn / jnp lower them at a shape of more than one
# element (the constants' broadcasts included)
_COMPOSITES = {
    "silu": {"negate": 1, "exponential": 1, "add": 1, "divide": 1,
             "multiply": 1, "broadcast": 1},
    "softplus": {"compare": 1, "maximum": 1, "abs": 1, "negate": 1,
                 "exponential": 1, "log-plus-one": 1, "add": 1,
                 "select": 1, "broadcast": 1},
    "gelu": {"multiply": 6, "add": 2, "tanh": 1, "broadcast": 4},
    "_softmax": {"reduce": 2, "maximum": 2, "add": 1, "subtract": 1,
                 "exponential": 1, "divide": 1, "broadcast": 5,
                 "reshape": 4},
    "cumsum": {"reduce-window": 1, "add": 1},
    "tril": {"iota": 2, "broadcast": 3, "compare": 1, "select": 1},
    "triu": {"iota": 2, "broadcast": 3, "compare": 1, "select": 1},
    "constant_pad_nd": {"pad": 1, "convert": 1},
    "sort": {"sort": 1},
    "topk": {"topk": 1},
}


def _base_name(func) -> str:
    """``aten.add_.Tensor`` -> ``add``: the overload packet's name with an
    in-place trailing underscore dropped."""
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.startswith("_"):
        return name[:-1]
    return name


def _hlo_class(opcode: str) -> str:
    """The op class of an HLO opcode (``conv`` and ``depthwise`` stand for
    a convolution by its group count)."""
    if opcode == "dot":
        return "dense"
    if opcode == "while":
        return "rnn"
    if opcode in ("conv", "depthwise"):
        return opcode
    if opcode in _HLO_RESHUFFLE:
        return "reshuffle"
    return "elementwise"        # unrecognized opcode: least-wrong bucket


def _numel(t) -> int:
    return math.prod(t.shape) if isinstance(t, torch.Tensor) else math.prod(t)


def _broadcast(src: tuple, out: tuple) -> Counter:
    """The ops ``jnp`` lowers broadcasting an operand of shape ``src`` to
    ``out`` to."""
    src, out = tuple(src), tuple(out)
    if src == out:
        return Counter()
    if not src:
        return Counter(broadcast=1)
    c = Counter()
    if len(src) < len(out):                 # rank promotion
        c["reshape"] += 1
        src = (1,) * (len(out) - len(src)) + src
    if src != out:                          # size-1 dims expand
        c["broadcast"] += 2
        c["reshape"] += 1
    return c


def _is_float(dt) -> bool:
    return dt.is_floating_point or dt.is_complex


def _is_int(dt) -> bool:
    return not _is_float(dt) and dt != torch.bool


def _converts(dtypes, to) -> int:
    """Operands that need a ``convert`` to compute in ``to``."""
    return sum(1 for dt in dtypes
               if dt != to and not (_is_int(dt) and _is_int(to)))


def _elementwise(name, args, out, ctx=None) -> Counter:
    """One elementwise op with its operands' broadcasts and converts
    (``ctx``, the counter, composes expanded operands and shares
    constants)."""
    out_t = out[0] if isinstance(out, (tuple, list)) else out
    operands = [a for a in args if isinstance(a, (torch.Tensor, bool, int,
                                                   float))]
    if name == "pow":
        c = _pow(args)
        if "multiply" in c:                 # no constant to broadcast
            operands = operands[:1]
    else:
        c = Counter({_ELEMENTWISE_OPS[name]: 1})
    tensors = [a for a in operands if isinstance(a, torch.Tensor)]
    for a in operands:
        if isinstance(a, torch.Tensor):
            c += _broadcast(a.shape if ctx is None
                            else ctx.composed_shape(a, out_t), out_t.shape)
        elif _numel(out_t) > 1 and (ctx is None
                                    or ctx.new_constant(a, out_t)):
            c["broadcast"] += 1             # a Python scalar's constant
    if name in _COMPARISONS:
        to = tensors[0].dtype
        for t in tensors[1:]:
            to = torch.promote_types(to, t.dtype)
    elif name in ("where", "masked_fill"):
        tensors, to = tensors[1:], out_t.dtype
    else:
        to = out_t.dtype
    c["convert"] += _converts([t.dtype for t in tensors if t.dim()], to)
    return c


def _pow(args) -> Counter:
    """``x ** 2`` is JAX's ``integer_pow``, lowered to multiplies."""
    base, exp = args[0], args[1]
    if isinstance(base, torch.Tensor) and isinstance(exp, int) \
            and not isinstance(exp, bool) and 1 <= exp <= 4:
        return Counter(multiply=exp - 1)
    return Counter(power=1)


def _reduction(name, args, kwargs, out) -> Counter:
    src = args[0]
    out_t = out[0] if isinstance(out, (tuple, list)) else out
    c = Counter(reduce=1)
    c[_REDUCTIONS[name]] += 1
    keepdim = kwargs.get("keepdim", False)
    for a in args[1:]:
        if isinstance(a, bool):
            keepdim = a
    if keepdim and src.dim() and out_t.dim() == src.dim() \
            and _numel(out_t) < _numel(src):
        c["reshape"] += 1
    if name == "mean":
        c["divide"] += 1
        if _numel(out_t) > 1:
            c["broadcast"] += 1
    if name in ("sum", "mean") and src.dtype in (torch.bfloat16,
                                                 torch.float16):
        c["convert"] += 2
    return c


def _lower(func, args, kwargs, out, ctx=None) -> Optional[Counter]:
    """HLO opcodes that JAX lowers the same array operation to; None for
    an op no table names."""
    name = _base_name(func)
    out_t = out[0] if isinstance(out, (tuple, list)) and out else out
    if name in _CONV_OPS:
        groups = kwargs.get("groups", args[8] if len(args) > 8 else 1)
        c = Counter({"depthwise" if int(groups) > 1 else "conv": 1})
        if len(args) > 2 and isinstance(args[2], torch.Tensor):
            c["add"] += 1                   # the bias
            c += _broadcast(args[2].shape, out_t.shape)
        return c
    if name in _DENSE_OPS:
        c = Counter(dot=1)
        if name.startswith("add") or name == "baddbmm":
            c["add"] += 1
            c += _broadcast(args[0].shape, out_t.shape)
        return c
    if name in _ELEMENTWISE_OPS or name == "pow":
        return _elementwise(name, args, out, ctx)
    if name == "clamp":
        lo = args[1] if len(args) > 1 else kwargs.get("min")
        hi = args[2] if len(args) > 2 else kwargs.get("max")
        c = Counter()
        for bound, op in ((lo, "maximum"), (hi, "minimum")):
            if bound is not None:
                c[op] += 1
                c += (_broadcast(bound.shape, out_t.shape)
                      if isinstance(bound, torch.Tensor)
                      else Counter(broadcast=int(_numel(out_t) > 1)))
        return c
    if name in ("max", "min") and len(args) > 1 \
            and isinstance(args[1], torch.Tensor):       # max.other
        return _elementwise("maximum" if name == "max" else "minimum",
                            args, out, ctx)
    if name in _REDUCTIONS:
        return _reduction(name, args, kwargs, out)
    if name in _COMPOSITES:
        return Counter(_COMPOSITES[name])
    if name == "_to_copy":
        src, dt = args[0].dtype, kwargs.get("dtype", args[0].dtype)
        return Counter(convert=_converts([src], dt))
    if name in _RESHAPES:
        return Counter(reshape=int(tuple(args[0].shape)
                                   != tuple(out_t.shape)))
    if name in _TRANSPOSES:
        moved = [d for d in args[0].shape if d != 1] \
            != [d for d in out_t.shape if d != 1]
        if not moved:                       # only size-1 dims move
            return Counter(reshape=int(tuple(args[0].shape)
                                       != tuple(out_t.shape)))
        return Counter(transpose=1)
    if name in ("expand", "expand_as", "broadcast_to"):
        return _broadcast(args[0].shape, out_t.shape)
    if name in _FILLS:
        return Counter(broadcast=int(_numel(out_t) > 1))
    if name in ("slice", "narrow"):
        return Counter(slice=int(tuple(args[0].shape)
                                 != tuple(out_t.shape)))
    if name in _SPLITS:
        return Counter(slice=len(out))
    if name == "unbind":
        return Counter(slice=len(out), reshape=len(out))
    if name == "cat":
        return Counter(concatenate=1)
    if name == "stack":                     # a mapped loop's results
        return Counter({"reshape": len(args[0]),
                        "dynamic-update-slice": len(args[0])})
    if name == "arange":
        nums = [a for a in args if isinstance(a, (int, float))]
        start, step = (0, 1) if len(nums) < 2 else (
            nums[0], nums[2] if len(nums) > 2 else 1)
        if step != 1:                       # a constant to JAX
            return Counter()
        return Counter(iota=1, **({"add": 1, "broadcast": 1} if start
                                  else {}))
    if name in ("index", "index_select", "embedding", "gather"):
        return Counter(gather=1, compare=1, add=1, select=1, broadcast=2,
                       reshape=1)
    if name in ("index_copy", "index_put", "copy", "slice_scatter",
                "select_scatter"):
        return Counter({"dynamic-update-slice": 1})
    if name in ("scatter", "scatter_add", "index_add"):
        return Counter(scatter=1)
    if name in ("flip", "roll"):
        return Counter(reverse=1)
    if name in _UNCLASSED_OPS or name.startswith("empty"):
        return Counter()
    return None


def _dense_flops(name: str, args, out) -> float:
    """2 * prod(output dims) * contracted dim of one dense product."""
    if name in ("mm", "bmm", "mv", "mixed_mm"):
        lhs = args[0]
    elif name in ("addmm", "baddbmm", "addmv"):
        lhs = args[1]
    elif name == "addbmm":                  # sums the batch into one product
        b, n, m = args[1].shape
        return 2.0 * b * n * m * args[2].shape[-1]
    else:                                   # dot, vdot
        return 2.0 * _numel(args[0])
    out_t = out if isinstance(out, torch.Tensor) else out[0]
    return 2.0 * _numel(out_t) * lhs.shape[-1]


def _conv_flops(args, out) -> float:
    """2 * prod(output dims) * (input channels per group) * kernel size."""
    weight = args[1]
    return 2.0 * _numel(out) * _numel(weight[0])


def _einsum_ops(equation: str) -> Counter:
    """``jnp.einsum``: one ``dot`` per contraction, and a ``transpose``
    where a two-operand product's natural order (batch dims, then the
    left's free dims, then the right's) is not the requested one."""
    eq = equation.replace(" ", "")
    lhs, _, res = eq.partition("->")
    ins = lhs.split(",")
    c = Counter(dot=max(len(ins) - 1, 1))
    if len(ins) == 2 and res:
        a, b = ins
        batch = [d for d in a if d in b and d in res]
        natural = batch + [d for d in a if d not in b and d in res] \
            + [d for d in b if d not in a and d in res]
        if "".join(natural) != res:
            c["transpose"] += 1
    return c


_MATMULS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__}


def _leaves(tree) -> list:
    """The leaves of an op's arguments or results: tuples, lists and dicts
    opened (a faster ``pytree.tree_leaves`` for what ops take)."""
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _tensors(tree) -> list:
    """The tensors of a tree, a DTensor as its local shard (what the
    counted local ops produced)."""
    return [x._local_tensor if is_dtensor(x) else x
            for x in _leaves(tree) if isinstance(x, torch.Tensor)]


# collective ops (``_c10d_functional``, DTensor's ``_dtensor``) -> the HLO
# kind and the ring factor on (result, operand) bytes of the reference's
# ``hlo_analysis``
_COLL_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")


def _collective(func) -> Optional[tuple]:
    """(kind, result factor, operand factor) of a collective op, None for
    any other op."""
    if getattr(func, "namespace", None) not in _COLL_NAMESPACES:
        return None
    name = func.overloadpacket.__name__
    if name in _NOT_COLLECTIVES:
        return None
    if "all_gather" in name:
        return "all-gather", 1, 0
    if "all_reduce" in name:
        return "all-reduce", 2, 0
    if "reduce_scatter" in name:
        return "reduce-scatter", 0, 1
    if "all_to_all" in name or "alltoall" in name:
        return "all-to-all", 1, 0
    return "collective-permute", 1, 0


_PROPAGATING = [0]     # DTensor's propagation through decompositions, open


def propagating() -> bool:
    """Whether DTensor is propagating a sharding through an op's
    decomposition (``dtensor_propagation_marked``)."""
    return _PROPAGATING[0] > 0


@contextlib.contextmanager
def dtensor_propagation_marked():
    """While open, ``propagating()`` is true inside DTensor's propagation
    of a sharding through an op's decomposition: the first time DTensor
    meets an op it has no rule for at an input layout, it runs the
    decomposition on meta tensors at the global shape to learn the output
    layout, and caches it.  Those ops are no part of the rank's program,
    and counting them would make a step's count depend on what ran
    before it in the process.  Raises where this torch has no such
    propagation to mark, as a count would then silently change."""
    try:
        from torch.distributed.tensor._decompositions import \
            DecompShardingStrategy as cls
        orig = cls.__dict__["propagate_strategy"]
    except (ImportError, KeyError) as e:
        raise NotImplementedError(
            f"torch {torch.__version__}: no DTensor propagation through "
            f"decompositions to mark ({e!r})") from e

    def marked(*a, **k):
        _PROPAGATING[0] += 1
        try:
            return orig(*a, **k)
        finally:
            _PROPAGATING[0] -= 1
    if getattr(orig, "_marks_propagation", False):
        yield                   # already marked by an enclosing use
        return
    marked._marks_propagation = True
    cls.propagate_strategy = marked
    try:
        yield
    finally:
        cls.propagate_strategy = orig


def _is_fake(leaves) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(x, FakeTensor) for x in leaves)


def _is_view(func) -> bool:
    """True when every result aliases an input without writing it."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _is_functional(func) -> bool:
    """True for an op that neither aliases nor writes any argument and
    returns only tensors: its meta result depends on nothing but the
    arguments' metadata."""
    schema = func._schema
    return (all(a.alias_info is None for a in schema.arguments)
            and bool(schema.returns)
            and all(r.alias_info is None and str(r.type) == "Tensor"
                    for r in schema.returns))


def _meta_key(x):
    """A hashable stand-in for one argument: a meta tensor by its
    metadata.  TypeError for a tensor with data, whose results have
    values a lookup could not give."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise TypeError("a tensor with data")
        return ("T", tuple(x.shape), x.stride(), x.storage_offset(),
                x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_meta_key(v) for v in x)
    hash(x)
    return x


class _OpCounter(TorchDispatchMode):
    def __init__(self, ranked: bool = False, reuse_meta: bool = True):
        """``ranked``: one rank's program on DTensors, counted for its
        FLOPs, bytes and collectives only (no HLO opcodes: the
        histogram), and not DTensor's own ops on host tensors.
        ``reuse_meta``: look a repeated functional op's result up instead
        of running its meta kernel again (``_run``)."""
        super().__init__()
        self.ranked = ranked
        self.classes = not ranked
        self.reuse_meta = reuse_meta
        # one node per counted op: (opcodes, operand ids, result ids,
        # writes an operand); what reaches no result is dropped at the end
        # as JAX drops dead code before it lowers
        self.nodes: list = []
        self._alive: list = []      # every tensor seen, so no id is reused
        self._producer: dict = {}   # tensor id -> index of its node
        self.flops = 0.0
        self.hbm = 0.0
        self.coll_bytes = Counter()
        self.coll_count = Counter()
        self.warnings: set = set()
        self.muted = 0          # inside a composite counted as a whole
        # id -> tensor (kept alive, so an id is never reused): float32
        # casts, reshapes, and the results of products
        self.upcasts: dict = {}
        self.reshaped: dict = {}
        self.products: dict = {}
        self._loops: dict = {}      # (axis, size) -> last index
        self._last = None           # the last integer index
        self.inputs: set = set()    # ids of the analyzed function's inputs
        self._consts: set = set()   # constants broadcast this iteration
        # unsqueeze results -> [node, uses composed into a broadcast,
        # the unsqueezed tensor's shape]
        self._expanded: dict = {}
        # functional ops' results by (op, argument metadata): a repeated
        # layer dispatches the same ops on the same shapes, and a meta
        # kernel is far slower than looking its result up
        self._results: dict = {}

    def _run(self, func, args, kwargs):
        if not self.reuse_meta or not _is_functional(func):
            return func(*args, **kwargs)
        try:
            key = (func, _meta_key(args), _meta_key(tuple(kwargs.items())))
        except TypeError:       # an unhashable argument or one with data
            return func(*args, **kwargs)
        meta = self._results.get(key)
        if meta is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            if all(t.device.type == "meta" for t in outs):
                self._results[key] = (isinstance(out, tuple), tuple(
                    (tuple(t.shape), t.stride(), t.dtype) for t in outs))
            return out
        is_tuple, outs = meta
        out = tuple(torch.empty_strided(shp, st, dtype=dt, device="meta")
                    for shp, st, dt in outs)
        return out if is_tuple else out[0]

    def count(self, opcodes: Counter, operands, results, *,
              written=None, indexed=None):
        """One node: ``written`` the operand an in-place op writes,
        ``indexed`` the tensor an integer index reads from."""
        ins, outs = _tensors(operands), _tensors(results)
        self._alive += ins + outs
        for t in outs:
            if not any(t is a for a in ins):     # not an in-place result
                self._producer[id(t)] = len(self.nodes)
        self.nodes.append((opcodes, {id(t) for t in ins},
                           {id(t) for t in outs},
                           None if written is None else id(written),
                           None if indexed is None else id(indexed)))

    def live_opcodes(self, results) -> Counter:
        """The opcodes of the nodes ``results`` or a write depends on.

        An integer index that only addresses an in-place write is that
        write's own index, as the reference's scan writes its outputs
        with a ``dynamic-update-slice`` of a reshaped result: it reads
        no ``dynamic-slice``."""
        uses = Counter(i for node in self.nodes for i in node[1])
        for key, (idx, composed, _) in self._expanded.items():
            if composed and composed == uses[key]:
                self.nodes[idx][0]["reshape"] -= 1
        for node in self.nodes:
            t = node[3]
            while t is not None and uses[t] == 1 \
                    and t in self._producer:
                src = self.nodes[self._producer[t]]
                if src[4] is None or not src[0]["dynamic-slice"]:
                    break
                src[0]["dynamic-slice"] -= 1
                t = src[4]
        live = {id(t) for t in _tensors(results)}
        total = Counter()
        for opcodes, ins, outs, written, _ in reversed(self.nodes):
            if written is not None or live & outs:
                live |= ins
                total.update(opcodes)
        return total

    def _loop_index(self, src, dim: int, i: int) -> Counter:
        """An integer index into ``src`` along ``dim``.  The port unrolls
        in Python the loops the reference scans (over stacked layers,
        over query and key blocks), so an index into a stacked axis
        stands for an iteration of that scan: the first index of a new
        value on an axis of that size counts the loop counter's
        increment and condition, index 0 the ``while`` and its last
        condition, and a loop over a non-leading axis also scans the
        block numbers (an ``iota``, sliced per iteration).  The index
        itself is a ``dynamic-slice`` and a ``reshape``, normalized as
        ``jnp`` indexes by a traced integer when the axis is not the
        scan's own."""
        n = src.shape[dim]
        i %= n
        if n == 1:                          # a squeeze
            return Counter(reshape=1)
        last, self._last = self._last, None
        if last is not None and last[0] is src and last[1:3] == (dim, i - 1) \
                and id(src) not in self.inputs:
            # one intermediate indexed at consecutive positions is an
            # index the reference writes unrolled too (a convolution's
            # taps): static slices, and the first one's loop undone
            static = Counter(slice=1, reshape=1)
            last[3].clear()
            last[3].update(static)
            self._loops = last[4]
            c = Counter(static)
            self._last = (src, dim, i, c, self._loops)
            return c
        loops = dict(self._loops)
        c = Counter({"dynamic-slice": 1, "reshape": 1})
        if dim:
            c.update(compare=1, add=1, select=1)
        if self._loops.get((dim, n)) != i:
            self._loops[(dim, n)] = i
            self._consts = set()
            c.update(add=1, compare=1)
            if i == 0:
                c.update({"while": 1, "compare": 1, "iota": int(dim > 0)})
            if dim:                 # the block number, and its offset
                c.update({"dynamic-slice": 1, "reshape": 1, "multiply": 1})
        self._last = (src, dim, i, c, loops)
        return c

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = _leaves((args, kwargs))
        if any(is_dtensor(x) for x in leaves):
            return NotImplemented   # DTensor runs it; its local ops come back
        if _is_fake(leaves) or propagating():
            return func(*args, **kwargs)    # DTensor's global-shape pass
        out = self._run(func, args, kwargs)
        if _is_fake(_leaves(out)):
            return out
        if self.ranked and not any(t.device.type == "meta" for t in
                                   _tensors((args, kwargs, out))):
            return out      # DTensor's own bookkeeping on the host
        name = _base_name(func)
        coll = _collective(func)
        if coll is not None:
            kind, f_out, f_in = coll
            nbytes = lambda ts: sum(_numel(t) * t.element_size()  # noqa: E731
                                    for t in _tensors(ts))
            self.coll_bytes[kind] += f_out * nbytes(out) + f_in * nbytes(args)
            self.coll_count[kind] += 1
        if name in _DENSE_OPS:
            self.flops += _dense_flops(name, args, out)
        elif name in _CONV_OPS:
            self.flops += _conv_flops(args, out)
        if not _is_view(func):
            self.hbm += sum(_numel(t) * t.element_size()
                            for t in _tensors((args, kwargs, out)))
        if self.classes and not self.muted:
            if getattr(func, "namespace", None) in _COLL_NAMESPACES:
                lowered = Counter({coll[0]: 1} if coll else {})
            elif name == "select":
                lowered = self._loop_index(args[0], args[1] % args[0].dim(),
                                           args[2])
            elif name in _RESHAPES and id(args[0]) in self.products:
                lowered = Counter()         # regroups a product's dims
            else:
                lowered = _lower(func, args, kwargs, out, self)
                if name in _RESHAPES and lowered["reshape"]:
                    self.reshaped[id(out)] = out
            if lowered is None:     # unrecognized op: least-wrong bucket
                self.warnings.add(f"unclassified op {func}: counted as "
                                  "elementwise")
                lowered = Counter({"?" + name: 1})
            if name == "_to_copy" and lowered["convert"] \
                    and out.dtype == torch.float32:
                self.upcasts[id(out)] = out
            writes = [a for a, s in zip(args, func._schema.arguments)
                      if s.alias_info is not None and s.alias_info.is_write]
            self.count(lowered, (args, kwargs), out,
                       written=writes[0] if writes else None,
                       indexed=args[0] if name == "select" else None)
            if name == "unsqueeze" and lowered["reshape"]:
                self._expanded[id(out)] = [len(self.nodes) - 1, 0,
                                           tuple(args[0].shape)]
        return out

    def composed_shape(self, t, out) -> tuple:
        """The shape an elementwise op broadcasts ``t`` from: an
        unsqueezed operand's own, as JAX composes ``x[..., None]`` into
        the consumer's ``broadcast_in_dim``."""
        entry = self._expanded.get(id(t))
        if entry is None or tuple(t.shape) == tuple(out.shape):
            return tuple(t.shape)
        entry[1] += 1
        return entry[2]

    def new_constant(self, value, out) -> bool:
        """False for a scalar constant this loop iteration broadcast to
        the same shape already: JAX emits one per computation."""
        key = (type(value), value, tuple(out.shape), out.dtype)
        if key in self._consts:
            return False
        self._consts.add(key)
        return True


class _Composites(TorchFunctionMode):
    """Counts ``einsum`` and ``matmul`` as the dots JAX lowers them to and
    mutes the ops ATen decomposes them into."""

    def __init__(self, counter: _OpCounter):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not torch.einsum and func not in _MATMULS:
            return func(*args, **kwargs)
        self.counter.muted += 1
        try:
            out = func(*args, **kwargs)
        finally:
            self.counter.muted -= 1
        if not self.counter.muted:
            if func is torch.einsum:
                ops = args[1:]
                if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
                    ops = ops[0]
                c = _einsum_ops(args[0])
            else:
                ops, c = args[:2], Counter(dot=1)
            # operands all cast up just for the product are the dot's own
            # preferred_element_type to JAX, no convert; one reshaped for
            # it is a grouping of the dot's dims, no reshape
            if all(id(t) in self.counter.upcasts for t in ops):
                c["convert"] -= sum(1 for t in ops if self.counter.upcasts.pop(
                    id(t), None) is not None)
            c["reshape"] -= sum(1 for t in ops if self.counter.reshaped.pop(
                id(t), None) is not None)
            self.counter.products[id(out)] = out
            self.counter.count(c, ops, out)
        return out


def _to_meta(x):
    if isinstance(x, torch.Tensor) and x.device.type != "meta":
        return torch.empty_like(x, device="meta")
    return x


def analyze_ops(fn, *args, reuse_meta: bool = True) -> dict:
    """Run ``fn(*args)`` on meta tensors (any tensor argument not on the
    meta device is replaced by an empty meta tensor of its shape and
    dtype) and count what it dispatches.  Returns ``analyze_hlo``'s keys
    (see the module docstring).  ``reuse_meta=False`` runs every op's
    meta kernel, as the program alone would, for a ``MemTracker`` around
    the count to see the allocations it makes."""
    args = pytree.tree_map(_to_meta, args)
    ranked = any(is_dtensor(t) for t in pytree.tree_leaves(args))
    counter = _OpCounter(ranked=ranked, reuse_meta=reuse_meta)
    counter.inputs = {id(t) for t in _tensors(args)}
    with torch.no_grad(), (dtensor_propagation_marked() if ranked
                           else contextlib.nullcontext()), counter, (
            contextlib.nullcontext() if ranked else _Composites(counter)):
        results = fn(*args)
    coll_bytes = {k: float(counter.coll_bytes[k]) for k in _COLLECTIVES}
    out = {
        "flops": counter.flops,
        "hbm_bytes": counter.hbm,
        "coll_bytes": coll_bytes,
        "coll_count": {k: counter.coll_count[k] for k in _COLLECTIVES},
        "total_coll_bytes": sum(coll_bytes.values()),
        "warnings": sorted(counter.warnings),
    }
    if ranked:      # the op classes describe a program, not a rank's part
        return {**out, "n_ops": None, "op_hist": None}
    op_counts = {k: 0.0 for k in OP_CLASSES}
    for opcode, n in counter.live_opcodes(results).items():
        op_counts[_hlo_class(opcode)] += float(n)
    n_ops = sum(op_counts.values())
    return {**out, "n_ops": n_ops,
            "op_hist": {k: (v / n_ops if n_ops else 0.0)
                        for k, v in op_counts.items()}}
