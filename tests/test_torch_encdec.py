"""Whisper (the encoder-decoder) against ``repro.models.api`` on the TINY
config: the reference's parameters converted leaf by leaf
(``params_from_jax``), the same tokens and frame embeddings from numpy;
prefill logits, the whole cache (``k``, ``v``, ``ck``, ``cv``), and three
decode steps' logits and the cache after them.  ``kernel_impl="xla"``
holds the plain paths together; ``"pallas"`` the reference's Pallas
kernels in interpret mode against the port's kernel wrappers, which on the
CPU take their plain versions.

Where the reference runs its pure-JAX blockwise attention (the encoder's
self-attention, both cross-attentions), the port's kernel path takes the
flash kernel with ``causal=False`` and, for one decode token's
cross-attention, the decode kernel over a transposed view of the cache:
the same function, rounded otherwise.  The tests below hold each of those
routes to the reference's function.

Tolerances: 1e-4 in float32 for whole models; in bfloat16 the JAX
``test_pallas_kernel_path_matches_xla`` bounds, 3e-2 for prefill and the
cache, 5e-2 for the decode steps; single attention calls at the kernels'
own bounds, 2e-5 in float32 and 2e-2 in bfloat16."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs.base import InputShape, get_config  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import api, encdec, layers  # noqa: E402
from test_torch_models import _leaves32, _torch_leaves  # noqa: E402

ARCH = "whisper_medium"
T, BATCH, STEPS = 24, 2, 3
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _configs(dtype, impl):
    return (jax_config(ARCH, tiny=True).replace(dtype=dtype, kernel_impl=impl),
            get_config(ARCH, tiny=True).replace(dtype=dtype, kernel_impl=impl))


def _params(cj):
    params = jax.jit(japi.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cj)
    return params, api.params_from_jax(jax.tree.map(np.asarray, params),
                                       device="cpu")


def _np(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _both(x, dtype):
    """A numpy array as a jax and a torch array of ``dtype``."""
    return (jnp.asarray(x).astype(jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _spy(monkeypatch, module, name, log):
    real = getattr(module, name)

    def spy(*args, **kw):
        log.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(module, name, spy)


def _run(dtype, impl, tol_prefill, tol_decode, monkeypatch):
    cj, ct = _configs(dtype, impl)
    params, tp = _params(cj)
    toks = np.random.default_rng(0).integers(
        0, cj.vocab_size, (BATCH, T)).astype(np.int32)
    aj, at = _both(_np((BATCH, cj.encoder_seq_len, cj.d_model), 1, 0.02),
                   dtype)
    cap = T + STEPS + 5
    flash, decode = [], []
    _spy(monkeypatch, flash_ops, "flash_attention", flash)
    _spy(monkeypatch, decode_ops, "decode_attention_kvmajor", decode)

    lj, cache_j = jax.jit(lambda p, b: japi.prefill(p, b, cj, capacity=cap))(
        params, {"tokens": jnp.asarray(toks), "audio_embeds": aj})
    lt, cache_t = api.prefill(tp, {"tokens": torch.from_numpy(toks),
                                   "audio_embeds": at}, ct, capacity=cap)
    assert sorted(cache_t) == ["ck", "cv", "k", "v"]
    _close(lt, lj, tol_prefill)
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
        _close(dt, dj, tol_decode)
        tok = np.asarray(jnp.argmax(dj, -1)).astype(np.int32)
    for a, b in zip(_torch_leaves(cache_t), _leaves32(cache_j)):
        _close(a, b, tol_decode)

    # the kernel path's calls: per prefill the encoder's layers (not
    # causal), the decoder's self-attention (causal) and its
    # cross-attention (not causal) through the flash wrapper; per decode
    # step one self- and one cross-attention through the decode wrapper
    Le, Ld = cj.encoder_layers, cj.num_layers
    if impl == "pallas":
        assert [kw["causal"] for _, kw in flash] == \
            [False] * Le + [True, False] * Ld
        assert len(decode) == 2 * Ld * STEPS
    else:
        assert flash == [] and decode == []


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_encdec_matches_reference_f32(impl, monkeypatch):
    _run("float32", impl, 1e-4, 1e-4, monkeypatch)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_encdec_matches_reference_bf16(impl, monkeypatch):
    _run("bfloat16", impl, 3e-2, 5e-2, monkeypatch)


def test_init_params_has_the_reference_tree():
    """Same leaves and shapes as the reference's tree: ``enc_layers`` and
    ``dec_layers`` stacked on a leading layer axis, the decoder's
    ``cross`` block with its ``cross_norm``, ``enc_norm``."""
    cj, ct = _configs("float32", "xla")
    ref = jax.eval_shape(lambda: japi.init_params(jax.random.PRNGKey(0), cj))
    got = api.init_params(ct, seed=0, device="cpu")
    assert [tuple(x.shape) for x in _torch_leaves(got)] == \
        [tuple(x.shape) for x in jax.tree.leaves(ref)]
    assert got["dec_layers"]["cross"]["cross_norm"].shape == \
        (ct.num_layers, ct.d_model)


def test_make_batch_and_init_cache_match_reference_shapes():
    cj, ct = _configs("bfloat16", "xla")
    shape = InputShape("serve", 40, 3, "prefill")
    ref = japi.batch_shapes(cj, shape)
    got = api.make_batch(ct, shape, seed=1, device="cpu")
    assert set(got) == set(ref) == {"tokens", "audio_embeds"}
    for name, (shp, dt) in ref.items():
        assert tuple(got[name].shape) == shp
        assert str(got[name].dtype).replace("torch.", "") == \
            jnp.dtype(dt).name
    assert api.prefill_len(got) == 40
    cache_j = japi.init_cache(cj, 3, 45)
    cache_t = api.init_cache(ct, 3, 45, device="cpu")
    for name in ("k", "v", "ck", "cv"):
        assert tuple(cache_t[name].shape) == cache_j[name].shape
        assert cache_t[name].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_noncausal_route_matches_reference_encode(dtype,
                                                          monkeypatch):
    """``encode`` on the kernel path sends each encoder layer's
    self-attention through the flash wrapper with ``causal=False`` and
    equals the reference's ``encode`` (its pure-JAX blockwise attention)."""
    cj, ct = _configs(dtype, "pallas")
    params, tp = _params(cj)
    aj, at = _both(_np((BATCH, cj.encoder_seq_len, cj.d_model), 3, 0.5),
                   dtype)
    calls = []
    _spy(monkeypatch, flash_ops, "flash_attention", calls)
    got = encdec.encode(tp, at, ct)
    want = jax.jit(lambda p, a: jencdec.encode(p, a, cj))(params, aj)
    assert [kw["causal"] for _, kw in calls] == [False] * cj.encoder_layers
    _close(got.float(), want, {"float32": 1e-5, "bfloat16": 3e-2}[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_cross_attention_reads_a_transposed_view(dtype, monkeypatch):
    """One decode token's cross-attention on the kernel path goes through
    ``decode_attention_kvmajor`` over ``ck[l].transpose(1, 2)``, a view of
    the cache in the reference's (B, S_enc, KV, hd) layout (no copy), at
    position S_enc - 1, and equals the reference's ``cross_attn_apply``."""
    cj, ct = _configs(dtype, "pallas")
    S, KV, hd, d = cj.encoder_seq_len, cj.num_kv_heads, cj.head_dim, cj.d_model
    pj = jlayers.init_attn_block(jax.random.PRNGKey(4), cj, cross=True)
    pt = api.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    xj, xt = _both(_np((BATCH, 1, d), 5), dtype)
    (ckj, ckt), (cvj, cvt) = (_both(_np((2, BATCH, S, KV, hd), s), dtype)
                              for s in (6, 7))
    calls = []
    _spy(monkeypatch, decode_ops, "decode_attention_kvmajor", calls)
    got = layers.cross_attn_apply(pt, xt, {"k": ckt[1], "v": cvt[1]}, ct)
    want = jlayers.cross_attn_apply(pj, xj, {"k": ckj[1], "v": cvj[1]}, cj)
    (q, k, v, pos), kw = calls[0]
    assert len(calls) == 1 and kw.get("window") is None
    for view, buf in ((k, ckt), (v, cvt)):
        assert view.data_ptr() == buf[1].data_ptr()
        assert view.shape == (BATCH, KV, S, hd)
        assert view.stride() == buf[1].transpose(1, 2).stride()
    assert int(pos.reshape(())) == S - 1
    _close(got.float(), want, KERNEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_cross_attention_matches_reference(dtype, monkeypatch):
    """A prompt's cross-attention on the kernel path goes through the flash
    wrapper with ``causal=False`` (Tq = prompt, Tk = S_enc) and equals the
    reference's ``cross_attn_apply``."""
    cj, ct = _configs(dtype, "pallas")
    S, KV, hd, d = cj.encoder_seq_len, cj.num_kv_heads, cj.head_dim, cj.d_model
    pj = jlayers.init_attn_block(jax.random.PRNGKey(4), cj, cross=True)
    pt = api.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    xj, xt = _both(_np((BATCH, T, d), 8), dtype)
    (kj, kt), (vj, vt) = (_both(_np((BATCH, S, KV, hd), s), dtype)
                          for s in (9, 10))
    calls = []
    _spy(monkeypatch, flash_ops, "flash_attention", calls)
    got = layers.cross_attn_apply(pt, xt, {"k": kt, "v": vt}, ct)
    want = jlayers.cross_attn_apply(pj, xj, {"k": kj, "v": vj}, cj)
    assert [kw["causal"] for _, kw in calls] == [False]
    _close(got.float(), want, KERNEL_TOL[dtype])


def test_generate_decodes_after_the_prompt():
    """``generate`` prefills the prompt tokens (the encoder's frames are not
    decoder positions) and decodes from there: its tokens equal a
    step-by-step greedy loop from position T."""
    _, ct = _configs("float32", "pallas")
    params = api.init_params(ct, seed=0, device="cpu")
    batch = api.make_batch(ct, InputShape("serve", T, 2, "prefill"), seed=1,
                           device="cpu")
    assert api.prefill_len(batch) == T
    out = api.generate(params, batch, ct, STEPS)
    logits, cache = api.prefill(params, batch, ct, capacity=T + STEPS)
    want = [logits.argmax(-1).to(torch.int32)]
    for i in range(STEPS):
        logits, cache = api.decode_step(params, cache, want[-1],
                                        torch.tensor(T + i,
                                                     dtype=torch.int32), ct)
        want.append(logits.argmax(-1).to(torch.int32))
    assert torch.equal(out, torch.stack(want, dim=1))
