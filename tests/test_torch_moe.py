"""``repro_torch.models.moe`` against ``repro.models.moe`` on the same
numpy inputs, with the reference's weights converted leaf by leaf
(``api.params_from_jax``): ``_route``'s dispatch, combine and aux loss and
``moe_apply``'s output and aux loss, over the three grouping branches
(T = 512 in groups of 256, T = 40 one group per sequence, T = 1 one group
of the batch) and a router biased so that one expert overflows its
capacity; ``capacity`` over a grid; ``init_moe``'s leaves.

Tolerances: 1e-5 in float32, 3e-2 in bfloat16."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import api, moe  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# (arch, experts, top-k): the two MoE TINY configs, and Qwen3's with 16
# experts and top-4, where a 256-token group overflows some experts
CONFIGS = [("qwen3_moe_30b_a3b", None, None), ("mixtral_8x22b", None, None),
           ("qwen3_moe_30b_a3b", 16, 4)]
# (B, T): groups of ROUTE_GROUP, one group per sequence, one group of the
# batch (decode)
SHAPES = [(2, 512), (2, 40), (8, 1)]


def _configs(arch, experts, k, dtype):
    cj = jax_config(arch, tiny=True).replace(dtype=dtype)
    ct = get_config(arch, tiny=True).replace(dtype=dtype)
    if experts:
        cj = cj.replace(num_experts=experts, num_experts_per_tok=k)
        ct = ct.replace(num_experts=experts, num_experts_per_tok=k)
    return cj, ct


def _both(cj, seed=0, router_bias=None):
    """The reference's MoE parameters, and their conversion; with
    ``router_bias``, expert 0's router column gets it on input feature 0."""
    pj = jmoe.init_moe(jax.random.PRNGKey(seed), cj)
    if router_bias is not None:
        pj["router"] = pj["router"].at[0, 0].add(router_bias)
    return pj, api.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")


def _inputs(shape, d, dtype, seed=1, feature0=None):
    """(jax, torch) copies of one normal input in ``dtype``, equal bit for
    bit; with ``feature0`` every token's feature 0 is set to it."""
    h = np.random.default_rng(seed).standard_normal((*shape, d))
    if feature0 is not None:
        h[..., 0] = feature0
    hj = jnp.asarray(h.astype(np.float32)).astype(dtype)
    ht = torch.from_numpy(np.array(hj, np.float32)).to(getattr(torch, dtype))
    return hj, ht


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _groups(hj, ht):
    """(jax, torch) routing groups of one input, as ``moe_apply`` forms
    them."""
    B, T, d = hj.shape
    if T > 1:
        n = jmoe.ROUTE_GROUP if T % jmoe.ROUTE_GROUP == 0 else T
        hgj = hj.reshape(B * T // n, n, d)
    else:
        hgj = hj.reshape(1, B, d)
    hgt = moe.route_groups(ht)
    assert tuple(hgt.shape) == hgj.shape
    return hgj, hgt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch,experts,k", CONFIGS)
def test_route_matches_reference(arch, experts, k, shape, dtype):
    cj, ct = _configs(arch, experts, k, dtype)
    pj, pt = _both(cj)
    hgj, hgt = _groups(*_inputs(shape, cj.d_model, dtype))
    C = moe.capacity(hgt.shape[1], ct.num_experts, ct.num_experts_per_tok)
    dj, cbj, auxj = jmoe._route(hgj, pj, cj, C)
    dt, cbt, auxt = moe._route(hgt, pt, ct, C)
    assert dt.shape == dj.shape == (*hgt.shape[:2], ct.num_experts, C)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    _close(cbt, cbj, TOL[dtype])
    _close(auxt, auxj, TOL[dtype])
    assert auxt.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch,experts,k", CONFIGS)
def test_moe_apply_matches_reference(arch, experts, k, shape, dtype):
    cj, ct = _configs(arch, experts, k, dtype)
    pj, pt = _both(cj, seed=2)
    hj, ht = _inputs(shape, cj.d_model, dtype, seed=3)
    yj, auxj = jmoe.moe_apply(pj, hj, cj)
    yt, auxt = moe.moe_apply(pt, ht, ct)
    assert yt.shape == ht.shape and yt.dtype == ht.dtype
    _close(yt, yj, TOL[dtype])
    _close(auxt, auxj, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_apply_matches_reference(dtype):
    cj, ct = _configs("qwen3_moe_30b_a3b", None, None, dtype)
    pj, pt = _both(cj, seed=4)
    xj, xt = _inputs((2, 40), cj.d_model, dtype, seed=5)
    oj, auxj = jmoe.moe_block_apply(pj, xj, cj)
    ot, auxt = moe.moe_block_apply(pt, xt, ct)
    _close(ot, oj, TOL[dtype])
    _close(auxt, auxj, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 40), (1, 256)])
def test_overflow_drops_tokens_as_reference(shape, dtype):
    """Feature 0 of every token at 4 and a router weight of 20 from it to
    expert 0: expert 0 is every token's first choice, so a group sends it
    n > C tokens in slot 0; the first C (in token order) keep a slot, the
    rest are dropped from it, in both packages alike."""
    cj, ct = _configs("qwen3_moe_30b_a3b", None, None, dtype)
    pj, pt = _both(cj, seed=6, router_bias=20.0)
    hj, ht = _inputs(shape, cj.d_model, dtype, seed=7, feature0=4.0)
    hgj, hgt = _groups(hj, ht)
    n = hgt.shape[1]
    C = moe.capacity(n, ct.num_experts, ct.num_experts_per_tok)
    assert n > C
    dj, cbj, _ = jmoe._route(hgj, pj, cj, C)
    dt, cbt, _ = moe._route(hgt, pt, ct, C)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    _close(cbt, cbj, TOL[dtype])
    kept = dt[:, :, 0].sum(-1)                       # (g, n): slot at expert 0
    assert (kept[:, :C] == 1).all() and (kept[:, C:] == 0).all()
    assert (dt[:, :, 0].sum(1) == 1).all()           # each slot used once
    yj, _ = jmoe.moe_apply(pj, hj, cj)
    yt, _ = moe.moe_apply(pt, ht, ct)
    _close(yt, yj, TOL[dtype])


@pytest.mark.parametrize("E", [1, 4, 8, 16, 128])
def test_capacity_matches_reference(E):
    for n in (1, 2, 3, 7, 8, 16, 40, 100, 256, 512, 4096):
        for k in (1, 2, 4, 8):
            if k > E:
                continue
            for factor in (1.0, 1.25, 2.0):
                got = moe.capacity(n, E, k, factor)
                assert got == jmoe.capacity(n, E, k, factor), (n, E, k, factor)
                assert got >= 4 and got % 4 == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "mixtral_8x22b"])
def test_init_moe_leaves_match_reference(arch, dtype):
    """Leaf names, shapes and dtypes as the reference's (unstacked, and
    stacked on a (3,) layer axis), normal at 0.02 with the norm at ones,
    each layer its own draw."""
    cj, ct = _configs(arch, None, None, dtype)
    ref = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(0), cj))
    gen = torch.Generator().manual_seed(0)
    one = moe.init_moe(gen, ct, (), getattr(torch, dtype), "cpu")
    stack = moe.init_moe(gen, ct, (3,), getattr(torch, dtype), "cpu")
    assert sorted(one) == sorted(stack) == sorted(ref)
    for name, want in ref.items():
        assert tuple(one[name].shape) == want.shape, name
        assert tuple(stack[name].shape) == (3, *want.shape), name
        assert str(one[name].dtype)[6:] == want.dtype.name == dtype, name
        assert stack[name].dtype == one[name].dtype
    assert (stack["norm"] == 1).all()
    for name in ("router", "wi", "wg", "wo"):
        std = stack[name].float().std().item()
        assert abs(std - 0.02) < 0.002, (name, std)
        assert abs(stack[name].float().mean().item()) < 0.002, name
    assert not torch.equal(stack["wi"][0], stack["wi"][1])


def test_route_breaks_exact_ties_as_reference():
    """Rows 3-7 of one (1, 8, 16) group are zero, so their router logits
    are all 0: an exact tie among every expert.  ``lax.top_k`` puts the
    lower index first among equal values; the port must pick the same
    experts, which also decides, through slot-major priority, which
    untied rows keep their capacity slots, and the aux loss."""
    cj, ct = (c.replace(d_model=16, num_experts=8)
              for c in _configs("qwen3_moe_30b_a3b", None, None, "float32"))
    pj, pt = _both(cj, seed=8)
    h = np.random.default_rng(9).standard_normal((1, 8, 16)).astype(
        np.float32)
    h[:, 3:] = 0.0
    C = moe.capacity(8, ct.num_experts, ct.num_experts_per_tok)
    dj, cbj, auxj = jmoe._route(jnp.asarray(h), pj, cj, C)
    dt, cbt, auxt = moe._route(torch.from_numpy(h), pt, ct, C)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    _close(cbt, cbj, 1e-6)
    _close(auxt, auxj, 1e-6)
