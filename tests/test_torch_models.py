"""Port models against ``repro.models.api`` on TINY configs (dense, MoE,
Mamba2 and the Zamba2 hybrid), on the
plain path (``kernel_impl="xla"``): prefill logits, the whole cache, one
decode step's logits and the updated cache.  Weights are the reference's,
converted leaf by leaf (``params_from_jax``); tokens come from numpy.

Tolerances: 1e-4 in float32; in bfloat16 the JAX
``test_pallas_kernel_path_matches_xla`` bounds, 3e-2 for prefill and the
cache, 5e-2 for the decode step.  The kernel path and the ring decode are
in test_torch_models_pallas.py."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import api  # noqa: E402

ARCHS = ["smollm_360m", "gemma2_2b", "qwen2_72b", "granite_20b",
         "mamba2_1p3b", "zamba2_1p2b", "qwen3_moe_30b_a3b", "mixtral_8x22b"]
T, CAP, BATCH = 40, 48, 2


def _leaves32(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _torch_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _torch_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _torch_leaves(v)]
    return [tree.float().numpy()]


def run_both(arch, dtype, impl, tol_prefill, tol_decode):
    cj = jax_config(arch, tiny=True).replace(dtype=dtype, kernel_impl=impl)
    ct = get_config(arch, tiny=True).replace(dtype=dtype, kernel_impl=impl)
    params = jax.jit(japi.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cj)
    tp = api.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    toks = np.random.default_rng(0).integers(
        0, cj.vocab_size, (BATCH, T)).astype(np.int32)

    lj, cache_j = jax.jit(lambda p, t: japi.prefill(
        p, {"tokens": t}, cj, capacity=CAP))(params, jnp.asarray(toks))
    lt, cache_t = api.prefill(tp, {"tokens": torch.from_numpy(toks)}, ct,
                              capacity=CAP)
    kw = dict(atol=tol_prefill, rtol=tol_prefill)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **kw)
    for a, b in zip(_torch_leaves(cache_t), _leaves32(cache_j)):
        np.testing.assert_allclose(a, b, **kw)

    tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    dj, cache_j = jax.jit(lambda p, c, t, pos: japi.decode_step(
        p, c, t, pos, cj))(params, cache_j, jnp.asarray(tok),
                           jnp.asarray(T, jnp.int32))
    dt, cache_t = api.decode_step(tp, cache_t, torch.from_numpy(tok),
                                  torch.tensor(T, dtype=torch.int32), ct)
    kw = dict(atol=tol_decode, rtol=tol_decode)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **kw)
    for a, b in zip(_torch_leaves(cache_t), _leaves32(cache_j)):
        np.testing.assert_allclose(a, b, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_plain_path_matches_reference_f32(arch):
    run_both(arch, "float32", "xla", 1e-4, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_plain_path_matches_reference_bf16(arch):
    run_both(arch, "bfloat16", "xla", 3e-2, 5e-2)
