"""The port's ``api.train_loss`` and its gradients against
``jax.value_and_grad`` of the reference's, on TINY configs in float32:
the dense, sliding-window, vision-stub and encoder-decoder families here,
Mamba2, Zamba2 and the MoE models in test_torch_train_models_ssm_moe.py.
Weights are the reference's, converted leaf by leaf
(``params_from_jax``); tokens and stub embeddings come from numpy.

Tolerances: the loss and its cross-entropy within 1e-4; every gradient
leaf within 1e-4 of that leaf's largest reference gradient.  Also here:
``remat`` changes nothing, the chunked cross-entropy's padded chunks, and
the train path on ``kernel_impl="pallas"`` with every kernel entry point
made to raise."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import api, transformer  # noqa: E402
from repro_torch.training.adamw import tree_leaves  # noqa: E402

BATCH, T = 2, 40


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in these tests: the suite runs several
    workers at once, and their thread pools contending for the cores slow
    the small ops of a TINY model tenfold or more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_batch(cfg, seed=0):
    """{'tokens', and the stub frontend's embeddings} as numpy arrays."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, T))
             .astype(np.int32)}
    n = {"vision_stub": ("patch_embeds", cfg.num_frontend_tokens),
         "audio_stub": ("audio_embeds", cfg.encoder_seq_len)}
    if cfg.frontend in n:
        name, count = n[cfg.frontend]
        batch[name] = (rng.standard_normal((BATCH, count, cfg.d_model))
                       * 0.02).astype(np.float32)
    return batch


def reference(arch, dtype="float32", seed=0):
    """(converted params, numpy batch, (loss, ce, aux), grad leaves) of the
    reference on ``arch``'s TINY config."""
    cj = jax_config(arch, tiny=True).replace(dtype=dtype)
    params = jax.jit(japi.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), cj)
    batch = make_batch(cj, seed)
    jb = {k: jnp.asarray(v) if k == "tokens" else
          jnp.asarray(v).astype(cj.dtype) for k, v in batch.items()}
    (loss, m), grads = jax.jit(jax.value_and_grad(
        lambda p: japi.train_loss(p, jb, cj, remat=False), has_aux=True))(
            params)
    tp = api.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    scalars = [float(x) for x in (loss, m["ce"], m["aux"])]
    return tp, batch, scalars, [np.asarray(g, np.float32)
                                for g in jax.tree.leaves(grads)]


def port(params, batch, cfg, remat=True):
    """((loss, ce, aux), grad leaves in ``jax.tree.leaves`` order)."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    it = iter(leaves)
    params = _rebuild(params, it)
    tb = {k: torch.from_numpy(v) if k == "tokens" else
          torch.from_numpy(v).to(leaves[0].dtype) for k, v in batch.items()}
    loss, m = api.train_loss(params, tb, cfg, remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return ([float(x.detach()) for x in (loss, m["ce"], m["aux"])],
            [g.float().numpy() for g in grads])


def _rebuild(tree, it):
    """``tree`` with its leaves taken in order from ``it``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def check_arch(arch):
    tp, batch, want, gwant = reference(arch)
    cfg = get_config(arch, tiny=True).replace(dtype="float32")
    got, ggot = port(tp, batch, cfg)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert len(ggot) == len(gwant)
    for i, (g, w) in enumerate(zip(ggot, gwant)):
        assert g.shape == w.shape, i
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), (
            i, np.abs(g - w).max(), np.abs(w).max())
    return tp, batch, cfg, got, ggot


@pytest.mark.parametrize("arch", ["smollm_360m", "gemma2_2b", "qwen2_72b",
                                  "granite_20b", "internvl2_2b",
                                  "whisper_medium"])
def test_train_loss_and_grads_match_reference_f32(arch):
    tp, batch, cfg, got, ggot = check_arch(arch)
    assert got[2] == 0.0                      # no MoE: no aux loss
    # remat recomputes each layer in the backward and changes nothing
    got2, ggot2 = port(tp, batch, cfg, remat=False)
    assert got2 == got
    for g, g2 in zip(ggot, ggot2):
        np.testing.assert_array_equal(g, g2)


@pytest.mark.parametrize("T_, chunk", [(40, 16), (40, 40), (33, 8)])
def test_chunked_ce_loss_pads_as_the_reference(T_, chunk):
    """Padded chunks (T not a multiple of ``chunk``) and their gradient
    with respect to h and the head."""
    cj = jax_config("gemma2_2b", tiny=True).replace(dtype="float32")
    cfg = get_config("gemma2_2b", tiny=True).replace(dtype="float32")
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, T_, cfg.d_model)).astype(np.float32)
    w = (rng.standard_normal((cfg.vocab_size, cfg.d_model)) * 0.1).astype(
        np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (2, T_)).astype(np.int32)
    mask = np.ones((2, T_), np.float32)
    mask[:, -1] = 0.0
    labels = np.roll(tokens, -1, axis=1)
    want, (gh, gw) = jax.value_and_grad(
        lambda h, w: jtransformer.chunked_ce_loss(
            {"embed": w}, h, jnp.asarray(labels), jnp.asarray(mask), cj,
            chunk=chunk), argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tl, tm = transformer.next_token_targets(torch.from_numpy(tokens))
    got = transformer.chunked_ce_loss({"embed": tw}, th, tl, tm, cfg,
                                      chunk=chunk)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5
    np.testing.assert_array_equal(tm.numpy(), mask)
    for g, w_ in ((th.grad, gh), (tw.grad, gw)):
        w_ = np.asarray(w_)
        assert np.abs(g.numpy() - w_).max() <= 1e-4 * np.abs(w_).max()


def _raise(*a, **k):
    raise AssertionError("the train path reached a kernel entry point")


KERNEL_ENTRY_POINTS = [
    ("repro_torch.kernels.flash_attention.ops", "flash_attention"),
    ("repro_torch.kernels.flash_attention.flash_attention",
     "flash_attention_fwd"),
    ("repro_torch.kernels.decode_attention.ops", "decode_attention"),
    ("repro_torch.kernels.decode_attention.ops", "decode_attention_kvmajor"),
    ("repro_torch.kernels.decode_attention.ops", "paged_decode_attention"),
    ("repro_torch.kernels.decode_attention.decode_attention",
     "decode_attention_fwd"),
    ("repro_torch.kernels.decode_attention.paged_decode_attention",
     "paged_decode_attention_fwd"),
    ("repro_torch.kernels.ssd_scan.ops", "ssd_scan"),
    ("repro_torch.kernels.ssd_scan.ssd_scan", "ssd_scan_fwd"),
]


@pytest.mark.parametrize("arch", ["smollm_360m", "gemma2_2b", "mamba2_1p3b",
                                  "zamba2_1p2b", "qwen3_moe_30b_a3b",
                                  "internvl2_2b", "whisper_medium"])
def test_train_path_reaches_no_kernel(arch, monkeypatch):
    """With ``kernel_impl="pallas"`` and every kernel entry point patched to
    raise, train_loss and its backward run, and equal the plain path's
    (the kernels have no backward).  The same entry points do serve a
    prefill (the patch is live)."""
    import importlib
    for mod, name in KERNEL_ENTRY_POINTS:
        monkeypatch.setattr(importlib.import_module(mod), name, _raise)
    cfg = get_config(arch, tiny=True).replace(dtype="float32")
    tp = api.init_params(cfg, seed=0, device="cpu")
    batch = make_batch(cfg)
    plain = port(tp, batch, cfg)
    kern = port(tp, batch, cfg.replace(kernel_impl="pallas"))
    assert kern[0] == plain[0]
    for g, g2 in zip(kern[1], plain[1]):
        np.testing.assert_array_equal(g, g2)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with pytest.raises(AssertionError, match="kernel entry point"):
        api.prefill(tp, tb, cfg.replace(kernel_impl="pallas"), capacity=T)
