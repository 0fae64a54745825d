"""Port models on the kernel path (``kernel_impl="pallas"``) against the
reference running its Pallas kernels in interpret mode, float32 at 1e-4
(and for Mamba2, Zamba2 and the two MoE models also bfloat16 at the JAX
bounds); and the ``windowed=True`` ring-buffer decode on gemma2 on both
paths.  On the CPU the port's kernel wrappers take their plain versions.

The port's prefill sends every Mamba block of a freshly allocated cache
through the SSD-scan kernel; the reference's prefill hands those blocks
the zero cache and so runs ``ssd_chunked`` (``models/mamba.py:173-178``).
Same function, other rounding: these tests hold the two to the same
bounds as everything else."""

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
from test_torch_models import _leaves32, _torch_leaves, run_both  # noqa: E402


@pytest.mark.parametrize("arch", ["smollm_360m", "gemma2_2b", "mamba2_1p3b",
                                  "zamba2_1p2b", "qwen3_moe_30b_a3b",
                                  "mixtral_8x22b"])
def test_kernel_path_matches_reference_pallas_f32(arch):
    run_both(arch, "float32", "pallas", 1e-4, 1e-4)


@pytest.mark.parametrize("arch", ["mamba2_1p3b", "zamba2_1p2b",
                                  "qwen3_moe_30b_a3b", "mixtral_8x22b"])
def test_kernel_path_matches_reference_pallas_bf16(arch):
    run_both(arch, "bfloat16", "pallas", 3e-2, 5e-2)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ring_decode_matches_reference(impl):
    """gemma2's local layers on a window-sized ring cache, written at
    pos % window, with the stale slot masked; global layers on the full
    cache.  The cache is filled from numpy and pos is past the window."""
    cj = jax_config("gemma2_2b", tiny=True).replace(dtype="float32",
                                                     kernel_impl=impl)
    ct = get_config("gemma2_2b", tiny=True).replace(dtype="float32",
                                                    kernel_impl=impl)
    cap, pos, B = 96, 80, 2
    params = jax.jit(japi.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), cj)
    tp = api.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    cache_j = japi.init_cache(cj, B, cap, windowed=True)
    rng = np.random.default_rng(2)
    filled = [rng.standard_normal(x.shape).astype(np.float32) * 0.5
              for x in jax.tree.leaves(cache_j)]
    cache_j = jax.tree.unflatten(jax.tree.structure(cache_j),
                                 [jnp.asarray(x) for x in filled])
    cache_t = api.init_cache(ct, B, cap, windowed=True, device="cpu")
    for dst, src in zip(_torch_leaves_ref(cache_t), filled):
        dst.copy_(torch.from_numpy(src))
    assert cache_t[0]["local"]["k"].shape[3] == cj.sliding_window

    tok = rng.integers(0, cj.vocab_size, (B,)).astype(np.int32)
    dj, cache_j = jax.jit(lambda p, c, t, i: japi.decode_step(
        p, c, t, i, cj, windowed=True))(params, cache_j, jnp.asarray(tok),
                                        jnp.asarray(pos, jnp.int32))
    dt, cache_t = api.decode_step(tp, cache_t, torch.from_numpy(tok),
                                  torch.tensor(pos, dtype=torch.int32), ct,
                                  windowed=True)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-4,
                               rtol=1e-4)
    for a, b in zip(_torch_leaves(cache_t), _leaves32(cache_j)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


def _torch_leaves_ref(tree):
    """The cache's tensors themselves (not copies), in jax's leaf order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _torch_leaves_ref(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _torch_leaves_ref(v)]
    return [tree]
