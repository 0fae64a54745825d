"""Port paged decode attention: the plain version (the CPU side of
``ops.paged_decode_attention``) and the ragged plain version against the
JAX package (its paged Pallas kernel in interpret mode, and its ragged
oracle), at the reference's tolerances: 2e-5 in float32, 2e-2 in
bfloat16.  The garbage-page, page-permutation and freed-slot properties,
and ``resolve_page_size``.  The CUDA kernel's own tests are in
test_torch_cuda_kernels.py."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.ops import \
    paged_decode_attention as jax_paged  # noqa: E402
from repro.kernels.decode_attention.ref import \
    decode_attention_ref_ragged as jax_ragged  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref, decode_attention_ref_ragged,
    paged_decode_attention_ref)
from repro_torch.perf import autotune  # noqa: E402

# the reference's PAGED_CASES (tests/test_paged_attention.py):
# (B, S, H, KV, hd, page_size, lens, window, cap)
PAGED_CASES = [
    (4, 512, 8, 2, 64, 64, (512, 300, 37, 1), None, None),   # ragged
    (1, 256, 4, 1, 128, 64, (200,), None, None),             # single slot, MQA
    (3, 384, 6, 3, 64, 128, (384, 129, 64), None, None),     # non-pow2 heads
    (2, 512, 8, 2, 64, 64, (500, 90), 128, None),            # sliding window
    (2, 256, 4, 4, 32, 32, (250, 31), None, 50.0),           # logit cap
    (3, 256, 8, 2, 64, 64, (256, 0, 10), None, None),        # freed slot
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(case, dtype, *, seed=11, perm_seed=None):
    """Seeded numpy q and dense cache, chopped into a (P, psz, KV, hd) pool
    and a block table (pages scattered through the pool by a permutation
    from ``perm_seed``), as (jax, torch) pairs rounded to ``dtype`` the
    same way on both sides."""
    B, S, H, KV, hd, psz, lens, _, _ = case
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    q, k, v = ((rng.standard_normal(s) * 0.5).astype(np.float32)
               for s in [(B, H, hd), (B, S, KV, hd), (B, S, KV, hd)])
    ns = S // psz
    P = B * ns
    kp, vp = k.reshape(P, psz, KV, hd), v.reshape(P, psz, KV, hd)
    tbl = np.arange(P, dtype=np.int32).reshape(B, ns)
    if perm_seed is not None:
        perm = np.random.default_rng(perm_seed).permutation(P)
        kp, vp = kp[perm], vp[perm]
        tbl = np.argsort(perm).astype(np.int32).reshape(B, ns)
    lens = np.asarray(lens, np.int32)

    def both(x, cast=True):
        if not cast:
            return jnp.asarray(x), torch.from_numpy(x)
        return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)

    return dict(q=both(q), k=both(k), v=both(v), kp=both(kp), vp=both(vp),
                tbl=both(tbl, False), lens=both(lens, False))


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", PAGED_CASES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_plain_matches_jax_paged_kernel(case, dtype):
    window, cap = case[-2:]
    x = _inputs(case, dtype, perm_seed=3)
    ref = jax_paged(*(x[n][0] for n in ("q", "kp", "vp", "lens", "tbl")),
                    window=window, logit_cap=cap)
    out = dec_ops.paged_decode_attention(
        *(x[n][1] for n in ("q", "kp", "vp", "lens", "tbl")), window=window,
        logit_cap=cap)
    assert out.dtype == DTYPES[dtype][1]
    _close(out, ref, DTYPES[dtype][2])


@pytest.mark.parametrize("case", PAGED_CASES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ragged_plain_matches_jax_ragged_ref(case, dtype):
    window, cap = case[-2:]
    x = _inputs(case, dtype)
    ref = jax_ragged(*(x[n][0] for n in ("q", "k", "v", "lens")),
                     window=window, logit_cap=cap)
    out = decode_attention_ref_ragged(
        *(x[n][1] for n in ("q", "k", "v", "lens")), window=window,
        logit_cap=cap)
    _close(out, ref, DTYPES[dtype][2])


def test_paged_ignores_garbage_in_unused_pages_and_table_entries():
    """Pages past a slot's length hold 1e4 and their table entries point
    far outside the pool: neither reaches the output."""
    case = (2, 256, 4, 2, 64, 64, (70, 128), None, None)
    x = _inputs(case, "float32", seed=13)
    q, k, v, kp, vp, tbl, lens = (x[n][1] for n in
                                  ("q", "k", "v", "kp", "vp", "tbl", "lens"))
    ref = decode_attention_ref_ragged(q, k, v, lens)
    ns = tbl.shape[1]
    used = torch.arange(ns)[None, :] < ((lens + 63) // 64)[:, None]
    page_used = used.reshape(-1)
    kp = torch.where(page_used[:, None, None, None], kp, torch.full_like(kp, 1e4))
    vp = torch.where(page_used[:, None, None, None], vp, torch.full_like(vp, 1e4))
    tbl = torch.where(used, tbl, torch.full_like(tbl, 10_000))
    out = dec_ops.paged_decode_attention(q, kp, vp, lens, tbl)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


def test_page_permutation_changes_nothing():
    """The same logical cache under three pool layouts gives the same
    output to the bit: the table, not the pool order, decides."""
    case = PAGED_CASES[0]
    outs = []
    for perm_seed in (None, 1, 2):
        x = _inputs(case, "float32", perm_seed=perm_seed)
        outs.append(dec_ops.paged_decode_attention(
            *(x[n][1] for n in ("q", "kp", "vp", "lens", "tbl"))))
    torch.testing.assert_close(outs[1], outs[0], atol=0, rtol=0)
    torch.testing.assert_close(outs[2], outs[0], atol=0, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_freed_slot_gives_exact_zeros(dtype):
    case = PAGED_CASES[-1]                       # lens (256, 0, 10)
    x = _inputs(case, dtype, perm_seed=4)
    out = dec_ops.paged_decode_attention(
        *(x[n][1] for n in ("q", "kp", "vp", "lens", "tbl")))
    ref = jax_paged(*(x[n][0] for n in ("q", "kp", "vp", "lens", "tbl")))
    assert (out[1] == 0).all()
    assert (np.asarray(ref[1], np.float32) == 0).all()
    assert out[0].abs().sum() > 0 and out[2].abs().sum() > 0


def test_paged_matches_dense_ref_when_uniform():
    """Every slot at one length: the paged path agrees with the positional
    oracle (cache valid on [0, pos])."""
    case = (2, 256, 8, 2, 64, 64, (200, 200), None, None)
    x = _inputs(case, "float32", seed=12)
    out = dec_ops.paged_decode_attention(
        *(x[n][1] for n in ("q", "kp", "vp", "lens", "tbl")))
    ref = decode_attention_ref(x["q"][1], x["k"][1], x["v"][1], 199)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(
        paged_decode_attention_ref(*(x[n][1] for n in
                                     ("q", "kp", "vp", "lens", "tbl"))),
        out, atol=0, rtol=0)


def test_resolve_page_size_explicit_then_tuned_then_default(tmp_path):
    geo = dict(B=4, H=8, KV=2, hd=32, seq_budget=256, device="cpu")
    prev = autotune._state["cache_dir"]     # restore, not pin, the location
    autotune.configure(cache_dir=str(tmp_path))
    try:
        assert dec_ops.resolve_page_size(torch.float32, page_size=32,
                                         **geo) == 32
        assert dec_ops.resolve_page_size(torch.float32, **geo) == \
            dec_ops.DEFAULT_PAGE_SIZE == 64
        entry = autotune.tune("paged_decode_attention", "float32",
                              device="cpu", iters=1, BKV=8, G=4, hd=32,
                              S=256)
        assert set(entry["config"]) == {"page_size"}
        assert dec_ops.resolve_page_size(torch.float32, **geo) == \
            entry["config"]["page_size"]
        assert dec_ops.resolve_page_size(torch.float32, page_size=128,
                                         **geo) == 128
    finally:
        autotune._state["cache_dir"] = prev
        autotune.configure(tune_on_miss=False)
