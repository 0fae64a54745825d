"""The port's ``api.train_loss`` and its gradients against the reference's
on TINY Mamba2, Zamba2 and the two MoE models in float32 (the other
families are in test_torch_train_models.py, whose helpers these use), the
MoE routing's gradients, and whole models in bfloat16.

Tolerances: float32 as in test_torch_train_models.py (loss within 1e-4,
each gradient leaf within 1e-4 of its largest reference gradient); the
routing's gradients in float32 within 1e-5 of their largest; bfloat16
within twice the reference's own gap between its bfloat16 and float32
results on the same (bfloat16) weights and inputs."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import api, moe  # noqa: E402
from test_torch_train_models import (check_arch, make_batch,  # noqa: E402
                                     one_torch_thread, port)  # noqa: F401


@pytest.mark.parametrize("arch", ["mamba2_1p3b", "zamba2_1p2b",
                                  "qwen3_moe_30b_a3b", "mixtral_8x22b"])
def test_train_loss_and_grads_match_reference_f32(arch):
    tp, batch, cfg, got, ggot = check_arch(arch)
    if cfg.num_experts:
        assert got[2] > 0.0                   # the load-balance loss is on
        assert got[0] == pytest.approx(
            got[1] + cfg.router_aux_loss_coef * got[2], abs=1e-6)
    got2, ggot2 = port(tp, batch, cfg, remat=False)
    assert got2 == got
    for g, g2 in zip(ggot, ggot2):
        np.testing.assert_array_equal(g, g2)


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "mixtral_8x22b"])
def test_route_gradients_match_reference(arch):
    """d/d(h, router) of sum(combine * R) + 3 * aux: through the stable
    sort's top-k values, the renormalised gates, ``combine`` and the aux
    loss's router probabilities."""
    cj = jax_config(arch, tiny=True).replace(dtype="float32")
    cfg = get_config(arch, tiny=True).replace(dtype="float32")
    rng = np.random.default_rng(11)
    g, n, d, E = 2, 24, cfg.d_model, cfg.num_experts
    h = rng.standard_normal((g, n, d)).astype(np.float32)
    router = (rng.standard_normal((d, E)) * 0.2).astype(np.float32)
    C = moe.capacity(n, E, cfg.num_experts_per_tok)
    R = rng.standard_normal((g, n, E, C)).astype(np.float32)

    def jloss(h, router):
        _, combine, aux = jmoe._route(h, {"router": router}, cj, C)
        return jnp.sum(combine * R) + 3.0 * aux

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h),
                                           jnp.asarray(router))
    th = torch.from_numpy(h).requires_grad_()
    tr = torch.from_numpy(router).requires_grad_()
    _, combine, aux = moe._route(th, {"router": tr}, cfg, C)
    ((combine * torch.from_numpy(R)).sum() + 3.0 * aux).backward()
    for got, w in zip((th.grad, tr.grad), want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        assert np.abs(got.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def _reference_grads(cj, params, batch):
    jb = {k: jnp.asarray(v) if k == "tokens" else
          jnp.asarray(v).astype(cj.dtype) for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: japi.train_loss(p, jb, cj, remat=False), has_aux=True))(
            params)
    return float(loss), [np.asarray(x, np.float32)
                         for x in jax.tree.leaves(grads)]


@pytest.mark.parametrize("arch", ["smollm_360m", "mamba2_1p3b"])
def test_train_grads_bf16_within_the_references_own_gap(arch):
    cj = jax_config(arch, tiny=True)
    assert cj.dtype == "bfloat16"
    params = jax.jit(japi.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cj)
    batch = make_batch(cj)
    want_loss, want = _reference_grads(cj, params, batch)
    f32 = cj.replace(dtype="float32")
    floor_loss, floor = _reference_grads(
        f32, jax.tree.map(lambda x: x.astype(jnp.float32), params), batch)
    tp = api.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    (loss, _, _), got = port(tp, batch, get_config(arch, tiny=True))
    assert abs(loss - want_loss) <= 2 * abs(want_loss - floor_loss) + 1e-6
    for i, (g, w, f) in enumerate(zip(got, want, floor)):
        gap = np.abs(w - f).max()
        assert np.abs(g - w).max() <= 2 * gap, (i, np.abs(g - w).max(), gap)
