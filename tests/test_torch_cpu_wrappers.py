"""On the CPU the port's kernel wrappers take what the reference's wrappers
take: the CUDA kernels' own limits (dtype, head_dim, state size, tile,
layout) apply only to a tensor off the CPU, and a CPU tensor goes to the
plain version.  The inputs here are ones the CUDA kernels do not take; the
same numpy inputs go through the JAX wrappers (their Pallas kernels in
interpret mode on the CPU) and the port's, at the reference's tolerances:
2e-5 in float32 and 2e-2 in a 16-bit type for attention, 2e-3 for the
chunked SSD scan.  That the same inputs still raise on the card is
test_torch_cuda_kernels.py's ``*_unsupported_cuda_input_raises``."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import ops as jax_dec  # noqa: E402
from repro.kernels.flash_attention import ops as jax_flash  # noqa: E402
from repro.kernels.ssd_scan import ops as jax_ssd  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402

# dtype name -> (jax dtype, torch dtype, attention tolerance)
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "float16": (jnp.float16, torch.float16, 2e-2),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pairs(seed, shapes, dtype, scale=0.5):
    """Seeded numpy arrays as (jax, torch) pairs in ``dtype``, rounded from
    float32 the same way on both sides."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    out = []
    for shp in shapes:
        x = (rng.standard_normal(shp) * scale).astype(np.float32)
        out.append((jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)))
    return out


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


# (hd, dtype): a head_dim no kernel takes (not a multiple of 8), and a dtype
# no kernel takes
ATTN_INPUTS = [(4, "float32"), (12, "float32"), (64, "float16")]


@pytest.mark.parametrize("hd,dtype", ATTN_INPUTS, ids=str)
@pytest.mark.parametrize("layout", ["bskd", "kvmajor"])
def test_decode_attention_takes_what_the_reference_takes(hd, dtype, layout):
    B, S, H, KV, pos = 2, 96, 6, 2, 70
    (qj, qt), (kj, kt), (vj, vt) = _pairs(
        1, [(B, H, hd), (B, S, KV, hd), (B, S, KV, hd)], dtype)
    want = jax_dec.decode_attention(qj, kj, vj, pos, window=48)
    if layout == "kvmajor":
        got = dec_ops.decode_attention_kvmajor(
            qt, kt.transpose(1, 2).contiguous(),
            vt.transpose(1, 2).contiguous(), pos, window=48)
    else:
        got = dec_ops.decode_attention(qt, kt, vt, pos, window=48)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("hd,dtype", ATTN_INPUTS, ids=str)
def test_paged_decode_attention_takes_what_the_reference_takes(hd, dtype):
    """A ragged batch with a freed slot, its pages scattered through the
    pool."""
    B, S, H, KV, psz = 3, 128, 4, 2, 32
    lens = np.asarray([128, 45, 0], np.int32)
    (qj, qt), (kj, kt), (vj, vt) = _pairs(
        2, [(B, H, hd), (B, S, KV, hd), (B, S, KV, hd)], dtype)
    ns, P = S // psz, B * (S // psz)
    perm = np.random.default_rng(3).permutation(P)
    tbl = np.argsort(perm).astype(np.int32).reshape(B, ns)
    kpj = kj.reshape(P, psz, KV, hd)[perm]
    vpj = vj.reshape(P, psz, KV, hd)[perm]
    kpt = kt.reshape(P, psz, KV, hd)[torch.from_numpy(perm)]
    vpt = vt.reshape(P, psz, KV, hd)[torch.from_numpy(perm)]
    want = jax_dec.paged_decode_attention(qj, kpj, vpj, jnp.asarray(lens),
                                          jnp.asarray(tbl), logit_cap=30.0)
    got = dec_ops.paged_decode_attention(qt, kpt, vpt, torch.from_numpy(lens),
                                         torch.from_numpy(tbl), logit_cap=30.0)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, DTYPES[dtype][2])
    assert (got[2] == 0).all()


@pytest.mark.parametrize("hd,dtype", ATTN_INPUTS, ids=str)
@pytest.mark.parametrize("tile", [(None, None), (32, 16)], ids=str)
def test_flash_attention_takes_what_the_reference_takes(hd, dtype, tile):
    """Any tile, as the reference's wrapper takes any: 32 x 16 is one no
    body of the kernel has."""
    B, T, H, KV = 1, 40, 6, 2
    (qj, qt), (kj, kt), (vj, vt) = _pairs(
        4, [(B, T, H, hd), (B, T, KV, hd), (B, T, KV, hd)], dtype)
    kw = dict(causal=True, block_q=tile[0], block_k=tile[1])
    want = jax_flash.flash_attention(qj, kj, vj, **kw)
    got = flash_ops.flash_attention(qt, kt, vt, **kw)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, want, DTYPES[dtype][2])


# (B, T, H, P, N, chunk, dt dtype): a head_dim and a state size the kernel
# does not take, and a bf16 dt
SSD_INPUTS = [
    (1, 128, 2, 128, 16, 64, "float32"),
    (1, 128, 2, 32, 256, 64, "float32"),
    (2, 128, 4, 64, 32, 64, "bfloat16"),
]


@pytest.mark.parametrize("case", SSD_INPUTS, ids=str)
def test_ssd_scan_takes_what_the_reference_takes(case):
    B, T, H, P, N, chunk, dt_dtype = case
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((B, T, H, P)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, T, H)), 0.0).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm = (rng.standard_normal((B, T, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, T, N)) * 0.5).astype(np.float32)
    jdt, tdt, _ = DTYPES[dt_dtype]
    yj, sj = jax_ssd.ssd_scan(jnp.asarray(x), jnp.asarray(dt).astype(jdt),
                              jnp.asarray(A), jnp.asarray(Bm),
                              jnp.asarray(Cm), chunk=chunk)
    yt, st = ssd_ops.ssd_scan(torch.from_numpy(x),
                              torch.from_numpy(dt).to(tdt),
                              torch.from_numpy(A), torch.from_numpy(Bm),
                              torch.from_numpy(Cm), chunk=chunk)
    assert yt.shape == (B, T, H, P) and st.shape == (B, H, P, N)
    _close(yt, yj, 2e-3)
    _close(st, sj, 2e-3)
