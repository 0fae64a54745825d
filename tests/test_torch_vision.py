"""InternVL2 (the vision stub) against ``repro.models.api`` on the TINY
config: the reference's parameters converted leaf by leaf
(``params_from_jax``), the same tokens and patch embeddings from numpy;
prefill logits, the whole cache, and three decode steps' logits and the
cache after them.  ``kernel_impl="xla"`` holds the plain paths together;
``"pallas"`` the reference's Pallas kernels in interpret mode against the
port's kernel wrappers, which on the CPU take their plain versions.

Tolerances: 1e-4 in float32; in bfloat16 the JAX
``test_pallas_kernel_path_matches_xla`` bounds, 3e-2 for prefill and the
cache, 5e-2 for the decode steps.  Also: ``generate`` sizes its cache and
its first decode position by the prefilled length, patches included."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs.base import InputShape, get_config  # noqa: E402
from repro_torch.models import api, transformer  # noqa: E402
from test_torch_models import _leaves32, _torch_leaves  # noqa: E402

ARCH = "internvl2_2b"
T_TEXT, BATCH, STEPS = 24, 2, 3


def _configs(dtype, impl):
    return (jax_config(ARCH, tiny=True).replace(dtype=dtype, kernel_impl=impl),
            get_config(ARCH, tiny=True).replace(dtype=dtype, kernel_impl=impl))


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, T_TEXT)).astype(np.int32)
    patches = (rng.standard_normal((BATCH, cfg.num_frontend_tokens,
                                    cfg.d_model)) * 0.02).astype(np.float32)
    return toks, patches


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def _run(dtype, impl, tol_prefill, tol_decode):
    cj, ct = _configs(dtype, impl)
    params = jax.jit(japi.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cj)
    tp = api.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    assert tp["vis_proj"].shape == (ct.d_model, ct.d_model)
    toks, patches = _inputs(cj)
    T = T_TEXT + cj.num_frontend_tokens
    cap = T + STEPS + 5
    bj = {"tokens": jnp.asarray(toks),
          "patch_embeds": jnp.asarray(patches).astype(jnp.dtype(dtype))}
    bt = {"tokens": torch.from_numpy(toks),
          "patch_embeds": torch.from_numpy(patches).to(getattr(torch, dtype))}
    lj, cache_j = jax.jit(lambda p, b: japi.prefill(p, b, cj, capacity=cap))(
        params, bj)
    lt, cache_t = api.prefill(tp, bt, ct, capacity=cap)
    _close(lt.numpy(), np.asarray(lj, np.float32), tol_prefill)
    for a, b in zip(_torch_leaves(cache_t), _leaves32(cache_j)):
        _close(a, b, tol_prefill)

    step = jax.jit(lambda p, c, t, pos: japi.decode_step(p, c, t, pos, cj))
    tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    for i in range(STEPS):
        dj, cache_j = step(params, cache_j, jnp.asarray(tok),
                           jnp.asarray(T + i, jnp.int32))
        dt, cache_t = api.decode_step(tp, cache_t, torch.from_numpy(tok),
                                      torch.tensor(T + i, dtype=torch.int32),
                                      ct)
        _close(dt.numpy(), np.asarray(dj, np.float32), tol_decode)
        tok = np.asarray(jnp.argmax(dj, -1)).astype(np.int32)
    for a, b in zip(_torch_leaves(cache_t), _leaves32(cache_j)):
        _close(a, b, tol_decode)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_vision_matches_reference_f32(impl):
    _run("float32", impl, 1e-4, 1e-4)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_vision_matches_reference_bf16(impl):
    _run("bfloat16", impl, 3e-2, 5e-2)


def test_init_params_adds_vis_proj_to_the_reference_tree():
    """The port's random init has the reference's tree: same keys and
    shapes, ``vis_proj`` (d, d) included."""
    cj, ct = _configs("float32", "xla")
    ref = jax.eval_shape(lambda: japi.init_params(jax.random.PRNGKey(0), cj))
    got = api.init_params(ct, seed=0, device="cpu")
    ref_shapes = [tuple(x.shape) for x in jax.tree.leaves(ref)]
    got_shapes = [tuple(x.shape) for x in _torch_leaves(got)]
    assert got_shapes == ref_shapes


def test_make_batch_matches_reference_shapes():
    """``make_batch`` gives the reference's leaves: tokens of the text
    length and patch embeddings in the config's dtype, P + text = the
    shape's positions."""
    cj, ct = _configs("bfloat16", "xla")
    shape = InputShape("serve", 40, 3, "prefill")
    ref = japi.batch_shapes(cj, shape)
    got = api.make_batch(ct, shape, seed=1, device="cpu")
    assert set(got) == set(ref) == {"tokens", "patch_embeds"}
    for name, (shp, dt) in ref.items():
        assert tuple(got[name].shape) == shp
        assert str(got[name].dtype).replace("torch.", "") == \
            jnp.dtype(dt).name
    assert api.prefill_len(got) == 40
    pe = got["patch_embeds"].float()
    assert 0.01 < pe.std().item() < 0.03


def test_generate_sizes_its_cache_by_the_prefilled_length(monkeypatch):
    """``generate`` on a vision batch prefills P + T positions, so its
    cache holds P + T + steps and the first decode step lands at P + T:
    its tokens equal a step-by-step greedy loop from those positions."""
    _, ct = _configs("float32", "pallas")
    params = api.init_params(ct, seed=0, device="cpu")
    batch = api.make_batch(ct, InputShape("serve", 32, 2, "prefill"), seed=1,
                           device="cpu")
    T = api.prefill_len(batch)
    assert T == 32 and batch["tokens"].shape[1] == 32 - ct.num_frontend_tokens
    caps = []
    real = transformer.prefill
    monkeypatch.setattr(transformer, "prefill",
                        lambda p, b, c, capacity: caps.append(capacity)
                        or real(p, b, c, capacity))
    out = api.generate(params, batch, ct, STEPS)
    assert caps == [T + STEPS]

    logits, cache = real(params, batch, ct, capacity=T + STEPS)
    assert cache[0]["k"].shape[3] == T + STEPS
    want = [logits.argmax(-1).to(torch.int32)]
    for i in range(STEPS):
        logits, cache = api.decode_step(params, cache, want[-1],
                                        torch.tensor(T + i,
                                                     dtype=torch.int32), ct)
        want.append(logits.argmax(-1).to(torch.int32))
    assert torch.equal(out, torch.stack(want, dim=1))
