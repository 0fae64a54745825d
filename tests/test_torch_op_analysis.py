"""``perf/op_analysis.py``, the port's counterpart of the reference's HLO
analysis: hand-built functions run on meta tensors, each checked for its
exact op count, op classes, FLOPs and bytes; the report has the
reference's keys and classes, a product's FLOPs equal what the
reference's analysis reads from the same product lowered by JAX, and the
op count and histogram of each function equal the reference's of the
same function written with ``jnp``."""

import pytest
import torch
import torch.nn.functional as F

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.perf import hlo_analysis as ref_ha  # noqa: E402
from repro_torch.perf import op_analysis as oa  # noqa: E402

F32 = 4


def _only(report, cls):
    """The report's histogram is all ``cls``."""
    assert report["op_hist"] == {c: float(c == cls) for c in oa.OP_CLASSES}


def test_report_has_the_references_keys_and_classes():
    assert oa.OP_CLASSES == ref_ha.OP_CLASSES
    rep = oa.analyze_ops(lambda a: a + 1.0, torch.zeros(2, 3))
    ref = ref_ha.analyze_hlo("")
    assert set(rep) == set(ref) - {"n_computations"}
    assert rep["coll_bytes"] == {k: 0.0 for k in ref["coll_bytes"]}
    assert rep["coll_count"] == {k: 0 for k in ref["coll_count"]}
    assert rep["total_coll_bytes"] == 0.0
    assert rep["warnings"] == []


def test_one_mm():
    rep = oa.analyze_ops(torch.mm, torch.zeros(4, 8), torch.zeros(8, 3))
    assert rep["n_ops"] == 1.0
    _only(rep, "dense")
    assert rep["flops"] == 2.0 * 4 * 3 * 8
    assert rep["hbm_bytes"] == (4 * 8 + 8 * 3 + 4 * 3) * F32


def test_mm_flops_equal_the_references_dot():
    text = ref_ha.hlo_for_module(
        jnp.dot, (jax.ShapeDtypeStruct((4, 8), jnp.float32),
                  jax.ShapeDtypeStruct((8, 3), jnp.float32)))
    ref = ref_ha.analyze_hlo(text)
    rep = oa.analyze_ops(torch.mm, torch.zeros(4, 8), torch.zeros(8, 3))
    assert rep["flops"] == ref["flops"] == 192.0
    assert rep["op_hist"]["dense"] == ref["op_hist"]["dense"] == 1.0


def test_bmm_and_addmm_flops():
    rep = oa.analyze_ops(torch.bmm, torch.zeros(5, 4, 8),
                         torch.zeros(5, 8, 3))
    assert (rep["n_ops"], rep["flops"]) == (1.0, 2.0 * 5 * 4 * 3 * 8)
    rep = oa.analyze_ops(torch.addmm, torch.zeros(3), torch.zeros(4, 8),
                         torch.zeros(8, 3))
    # the dot, the bias add, and the bias broadcast from (3,) to (4, 3):
    # a rank-promoting reshape, then broadcast, reshape, broadcast
    assert (rep["n_ops"], rep["flops"]) == (6.0, 2.0 * 4 * 3 * 8)
    assert rep["op_hist"]["dense"] == 1 / 6


def test_addbmm_flops_sum_the_batch():
    rep = oa.analyze_ops(torch.addbmm, torch.zeros(4, 3),
                         torch.zeros(5, 4, 8), torch.zeros(5, 8, 3))
    assert rep["flops"] == 2.0 * 5 * 4 * 8 * 3


@pytest.mark.parametrize("groups,cls", [(1, "conv"), (6, "depthwise")])
def test_convolution(groups, cls):
    x = torch.zeros(2, 6, 10)
    w = torch.zeros(6 if groups > 1 else 4, 6 // groups, 3)
    rep = oa.analyze_ops(lambda x, w: F.conv1d(x, w, groups=groups), x, w)
    assert rep["n_ops"] == 1.0
    _only(rep, cls)
    out = 2 * w.shape[0] * 8                       # (2, C_out, 10 - 3 + 1)
    assert rep["flops"] == 2.0 * out * (6 // groups) * 3
    assert rep["hbm_bytes"] == (x.numel() + w.numel() + out) * F32


def test_elementwise_chain():
    x = torch.zeros(3, 40)
    rep = oa.analyze_ops(lambda a: (a * 2.0 + a).exp().sum(), x)
    # multiply and its constant's broadcast, add, exponential, and the
    # sum's reduce with its reducer's add
    assert rep["n_ops"] == 6.0
    assert rep["op_hist"] == {**{c: 0.0 for c in oa.OP_CLASSES},
                              "elementwise": 5 / 6, "reshuffle": 1 / 6}
    assert rep["flops"] == 0.0
    n = x.numel() * F32
    assert rep["hbm_bytes"] == (2 * n) + (3 * n) + (2 * n) + (n + F32)


def test_view_chain_moves_no_bytes():
    rep = oa.analyze_ops(
        lambda a: a.view(12, 10).permute(1, 0).unsqueeze(0).expand(2, -1, -1),
        torch.zeros(2, 6, 10))
    # reshape, transpose, reshape, and the expansion of the size-1 dim:
    # broadcast, reshape, broadcast
    assert rep["n_ops"] == 6.0
    _only(rep, "reshuffle")
    assert rep["hbm_bytes"] == 0.0


def test_to_copy_is_elementwise():
    x = torch.zeros(2, 6, 10)
    rep = oa.analyze_ops(lambda a: a.to(torch.bfloat16), x)
    assert rep["n_ops"] == 1.0                     # XLA's convert
    _only(rep, "elementwise")
    assert rep["hbm_bytes"] == x.numel() * (F32 + 2)


def test_sort_is_reshuffle():
    x = torch.zeros(2, 6, 10)
    rep = oa.analyze_ops(lambda a: torch.sort(a, dim=-1), x)
    assert rep["n_ops"] == 1.0
    _only(rep, "reshuffle")
    assert rep["hbm_bytes"] == x.numel() * (F32 + F32 + 8)  # values, int64


def test_allocations_are_unclassed_and_arguments_go_to_meta():
    seen = []

    def fn(a):
        seen.append(a.device.type)
        buf = torch.empty_like(a)
        return buf.detach()

    rep = oa.analyze_ops(fn, torch.ones(3, 3))
    assert seen == ["meta"]
    assert rep["n_ops"] == 0.0
    assert rep["op_hist"] == {c: 0.0 for c in oa.OP_CLASSES}


def test_repeated_ops_are_counted_each_time():
    """A layer run twice on the same shapes counts twice, though the
    second run's results come from the metadata cache."""
    def layer(x, w):
        return torch.tanh(x @ w) + x

    once = oa.analyze_ops(layer, torch.zeros(4, 8), torch.zeros(8, 8))
    twice = oa.analyze_ops(lambda x, w: layer(layer(x, w), w),
                           torch.zeros(4, 8), torch.zeros(8, 8))
    assert twice["n_ops"] == 2 * once["n_ops"]
    assert twice["flops"] == 2 * once["flops"]
    assert twice["hbm_bytes"] == 2 * once["hbm_bytes"]
    assert twice["op_hist"] == once["op_hist"]


def test_values_computed_on_the_host_stay_values():
    """Ops on tensors with data inside ``fn`` run for real each time: the
    metadata cache serves meta tensors only."""
    got = []

    def fn(a):
        for n in (3, 5):
            got.append(int(torch.arange(n).sum()))
            got.append(int(torch.arange(n).sum()))
        return a + 1.0

    rep = oa.analyze_ops(fn, torch.zeros(4))
    assert got == [3, 3, 10, 10]
    # the host's aranges and sums reach no result: dead code, as JAX
    # drops it; the add and its constant's broadcast remain
    assert rep["n_ops"] == 2.0


def test_unclassified_op_is_elementwise_with_a_warning():
    rep = oa.analyze_ops(lambda a: torch.special.bessel_j0(a),
                         torch.zeros(4))
    _only(rep, "elementwise")
    assert rep["warnings"] and "bessel_j0" in rep["warnings"][0]


def _scan_torch(x, w):
    for i in range(w.shape[0]):
        x = torch.tanh(x @ w[i])
    return x


def _scan_jax(x, w):
    return lax.scan(lambda x, wi: (jnp.tanh(x @ wi), None), x, w)[0]


JF32, JBF16 = jnp.float32, jnp.bfloat16
# (the port's function, the same function in jnp, argument shapes)
SAME_FUNCTION = {
    "chain": (lambda a: (a * 2.0 + a).exp().sum(),
              lambda a: jnp.sum(jnp.exp(a * 2.0 + a)), [((3, 40), JF32)]),
    "views": (lambda a: a.view(12, 10).permute(1, 0).unsqueeze(0)
              .expand(2, -1, -1),
              lambda a: jnp.broadcast_to(a.reshape(12, 10).T[None],
                                         (2, 10, 12)), [((2, 6, 10), JF32)]),
    "addmm": (torch.addmm, lambda b, x, w: b + x @ w,
              [((3,), JF32), ((4, 8), JF32), ((8, 3), JF32)]),
    "broadcasts": (lambda a, b, c: a * b + c, lambda a, b, c: a * b + c,
                   [((4, 8), JF32), ((4, 1), JF32), ((8,), JF32)]),
    "rmsnorm": (lambda x, w: (x.float() * torch.rsqrt(
        x.float().square().mean(-1, keepdim=True) + 1e-6)
        * w.float()).to(torch.bfloat16),
        lambda x, w: (x.astype(JF32) * lax.rsqrt(jnp.mean(jnp.square(
            x.astype(JF32)), -1, keepdims=True) + 1e-6)
            * w.astype(JF32)).astype(JBF16),
        [((2, 5, 16), JBF16), ((16,), JBF16)]),
    "softmax": (lambda s: torch.softmax(s, -1),
                lambda s: jax.nn.softmax(s, -1), [((2, 3, 8), JF32)]),
    "silu_mlp": (lambda h, wg, wi, wo: (F.silu(h @ wg) * (h @ wi)) @ wo,
                 lambda h, wg, wi, wo: (jax.nn.silu(h @ wg) * (h @ wi)) @ wo,
                 [((2, 4, 8), JF32), ((8, 16), JF32), ((8, 16), JF32),
                  ((16, 8), JF32)]),
    "einsum_transposed": (
        lambda q, k: torch.einsum("bqkgd,bskd->bkgqs", q, k),
        lambda q, k: jnp.einsum("bqkgd,bskd->bkgqs", q, k),
        [((1, 4, 2, 3, 8), JF32), ((1, 5, 2, 8), JF32)]),
    "unsqueezed_operand": (lambda x, a: x * torch.cos(a)[..., None, :],
                           lambda x, a: x * jnp.cos(a)[..., None, :],
                           [((1, 4, 3, 8), JF32), ((1, 4, 8), JF32)]),
    "dead_code": (lambda a: (a.sum(), a.exp())[1],
                  lambda a: (a.sum(), jnp.exp(a))[1], [((4, 8), JF32)]),
    "cumsum": (lambda a: torch.cumsum(a, 1), lambda a: jnp.cumsum(a, 1),
               [((4, 8), JF32)]),
    "shared_constant": (lambda a, b: a * 2.0 + b * 2.0,
                        lambda a, b: a * 2.0 + b * 2.0,
                        [((4, 8), JF32), ((4, 8), JF32)]),
    "layer_loop": (_scan_torch, _scan_jax,
                   [((2, 8), JF32), ((3, 8, 8), JF32)]),
}
_TORCH = {JF32: torch.float32, JBF16: torch.bfloat16}


@pytest.mark.parametrize("case", sorted(SAME_FUNCTION))
def test_counts_equal_the_references_lowering(case):
    """The op count and histogram of a function equal the reference's
    analysis of the same function lowered by JAX (a Python layer loop
    against ``lax.scan``)."""
    fn, jfn, shapes = SAME_FUNCTION[case]
    rep = oa.analyze_ops(fn, *[torch.zeros(s, dtype=_TORCH[d])
                               for s, d in shapes])
    ref = ref_ha.analyze_hlo(ref_ha.hlo_for_module(
        jfn, [jax.ShapeDtypeStruct(s, d) for s, d in shapes]))
    assert rep["n_ops"] == ref["n_ops"]
    assert rep["op_hist"] == pytest.approx(ref["op_hist"], abs=1e-12)
    assert rep["flops"] == ref["flops"]
