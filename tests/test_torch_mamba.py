"""Port Mamba2 block (``repro_torch.models.mamba``) and its place in the
model, against the JAX package and against itself.

Inputs come from numpy seeds and weights from the reference's own init,
converted leaf by leaf (``params_from_jax``).  Whole-model parity for the
Mamba2 and Zamba2 TINY configs is in test_torch_models*.py.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from test_torch_models import _torch_leaves  # noqa: E402
from test_torch_ssd import ssd_arrays  # noqa: E402


def test_ssd_chunked_respects_initial_state():
    """The port's counterpart of test_ssd_scan_respects_initial_state: a
    full pass equals two half passes chaining the state (2e-3)."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in ssd_arrays(1, 128, 2, 32, 16, seed=3))
    y_full, s_full = M.ssd_chunked(x, dt, A, Bm, Cm, 64)
    h = 64
    _, s1 = M.ssd_chunked(x[:, :h], dt[:, :h], A, Bm[:, :h], Cm[:, :h], 64)
    y2, s2 = M.ssd_chunked(x[:, h:], dt[:, h:], A, Bm[:, h:], Cm[:, h:], 64,
                           init_state=s1)
    torch.testing.assert_close(y_full[:, h:], y2, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(s_full, s2, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("chunk", [32, 256])
def test_ssd_chunked_matches_reference_with_initial_state(chunk):
    """The port's ssd_chunked against the reference's on the same inputs
    and a nonzero initial state, float32: same algorithm, 1e-5."""
    arrs = ssd_arrays(2, 96, 4, 32, 16, seed=4)
    s0 = (np.random.default_rng(5).standard_normal((2, 4, 32, 16)) * 0.5
          ).astype(np.float32)
    yj, sj = jax.jit(JM.ssd_chunked, static_argnums=5)(
        *(jnp.asarray(a) for a in arrs), chunk, jnp.asarray(s0))
    yt, st = M.ssd_chunked(*(torch.from_numpy(a) for a in arrs), chunk,
                           init_state=torch.from_numpy(s0))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5, rtol=1e-5)


def _count_kernel_calls(monkeypatch):
    """Record the chunk of every call of the SSD-scan kernel wrapper."""
    calls = []
    real = ssd_ops.ssd_scan

    def spy(*a, **kw):
        calls.append(kw.get("chunk"))
        return real(*a, **kw)

    monkeypatch.setattr(ssd_ops, "ssd_scan", spy)
    return calls


def test_init_mamba_state_matches_reference():
    cj = jax_config("zamba2_1p2b", tiny=True)
    ct = get_config("zamba2_1p2b", tiny=True)
    sj = JM.init_mamba_state(cj, 3)
    st = M.init_mamba_state(ct, 3, device="cpu")
    for name in ("ssm", "conv"):
        assert tuple(st[name].shape) == sj[name].shape
        assert str(st[name].dtype).split(".")[-1] == str(sj[name].dtype)
        assert not st[name].any()


def _block_prefill_against_reference(T, seed, monkeypatch):
    """mamba_block_apply(state=None, mode="prefill") with
    kernel_impl="pallas" on one (2, T) input, the reference's and the
    port's; output and new state, float32 at 1e-4.  Returns the chunks the
    port's kernel wrapper was called with."""
    cj = jax_config("mamba2_1p3b", tiny=True).replace(dtype="float32",
                                                       kernel_impl="pallas")
    ct = get_config("mamba2_1p3b", tiny=True).replace(dtype="float32",
                                                      kernel_impl="pallas")
    pj = JM.init_mamba_block(jax.random.PRNGKey(seed), cj)
    pt = api.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    x = (np.random.default_rng(seed + 3).standard_normal((2, T, cj.d_model))
         ).astype(np.float32)
    yj, sj = jax.jit(lambda p, x: JM.mamba_block_apply(
        p, x, cj, state=None, mode="prefill"))(pj, jnp.asarray(x))
    calls = _count_kernel_calls(monkeypatch)
    yt, st = M.mamba_block_apply(pt, torch.from_numpy(x), ct, state=None,
                                 mode="prefill")
    kw = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **kw)
    for name in ("ssm", "conv"):
        np.testing.assert_allclose(st[name].numpy(), np.asarray(sj[name]), **kw)
    return calls


def test_mamba_block_kernel_prefill_matches_reference(monkeypatch):
    """The reference reaches its Pallas SSD kernel (interpret mode), the
    port its kernel wrapper (the plain version on the CPU)."""
    T = 64
    calls = _block_prefill_against_reference(T, 3, monkeypatch)
    assert calls == [T]                  # chunk = min(ssm_chunk_size, T)


@pytest.mark.parametrize("T", [300, 700])
def test_mamba_block_kernel_prefill_takes_any_chunkable_T(T, monkeypatch):
    """A T that ``min(ssm_chunk_size, T)`` does not divide still reaches
    the port's kernel wrapper, at the chunk ``ssd_chunked`` would use (300
    -> 300, 700 -> 350); the reference runs ``ssd_chunked`` there."""
    calls = _block_prefill_against_reference(T, 4, monkeypatch)
    assert calls == [T // max(T // 256, 1)]


@pytest.mark.parametrize("arch", ["mamba2_1p3b", "zamba2_1p2b"])
def test_fresh_prefill_through_kernel_equals_cache_route(arch, monkeypatch):
    """``prefill`` starts at cache position 0, so its Mamba blocks get
    ``state=None`` and, on the kernel path, reach the SSD-scan kernel once
    each; the plain path runs ``ssd_chunked``, the route the reference's
    prefill takes from its zeroed cache.  Same function: logits and the
    whole cache agree at 1e-5 in float32."""
    cfg = get_config(arch, tiny=True).replace(dtype="float32",
                                              kernel_impl="pallas")
    params = api.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 48)).astype(np.int32))
    calls = _count_kernel_calls(monkeypatch)
    lk, ck = api.prefill(params, {"tokens": toks}, cfg, capacity=56)
    n_mamba = sum(count * (cfg.hybrid_attn_every if kind == "hybrid_super"
                           else 1)
                  for kind, count in cfg.layer_groups)
    assert calls == [48] * n_mamba

    lc, cache = api.prefill(params, {"tokens": toks},
                            cfg.replace(kernel_impl="xla"), capacity=56)
    assert len(calls) == n_mamba        # the plain path took no kernel
    torch.testing.assert_close(lk, lc, atol=1e-5, rtol=1e-5)
    for a, b in zip(_torch_leaves(ck), _torch_leaves(cache)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-1)])
@pytest.mark.parametrize("arch", ["mamba2_1p3b", "zamba2_1p2b"])
def test_decode_matches_prefill(arch, dtype, tol, impl):
    """Prefilling [t0..tN] equals prefilling [t0..tN-1] then decoding tN
    (the reference's test_decode_matches_prefill, its 2e-1 in bfloat16;
    1e-4 in float32), with the reference's weights."""
    cj = jax_config(arch, tiny=True).replace(dtype=dtype)
    ct = get_config(arch, tiny=True).replace(dtype=dtype, kernel_impl=impl)
    params = jax.jit(japi.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cj)
    tp = api.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    T = 32
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, ct.vocab_size, (1, T)).astype(np.int32))
    full, _ = api.prefill(tp, {"tokens": tokens}, ct, capacity=T + 4)
    _, cache = api.prefill(tp, {"tokens": tokens[:, :-1]}, ct, capacity=T + 4)
    step, _ = api.decode_step(tp, cache, tokens[:, -1],
                              torch.tensor(T - 1, dtype=torch.int32), ct)
    torch.testing.assert_close(step, full, atol=tol, rtol=tol)
    assert int(step.argmax()) == int(full.argmax())
