"""Port SSD-scan kernel (K4): plain versions and wrapper against the JAX
package, and the wrapper's dispatch.

The same numpy inputs go through the reference (``repro.kernels.ssd_scan``:
the jnp recurrence ``ssd_ref``, and ``ops.ssd_scan``, which runs the Pallas
kernel in interpret mode on the CPU) and the port's plain PyTorch versions.
The recurrences compute the same sums in the same order: 1e-5.  The
chunked forms sum in another order: the reference's 2e-3.  The CUDA
kernel's own tests, which need a GPU, are in test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ops as jax_ops  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_ref  # noqa: E402

# a copy of the reference's case list (tests/test_kernels.py):
# (B, T, H, P, N, chunk)
SSD_CASES = [
    (2, 256, 4, 64, 32, 64),
    (1, 128, 8, 32, 16, 128),
    (2, 512, 2, 64, 64, 128),
    (1, 256, 64, 64, 128, 64),                    # mamba2-1.3b-like head count
]


def ssd_arrays(B, T, H, P, N, seed):
    """The reference test's distributions, drawn with numpy: x, dt
    (softplus'd), A (negative), Bm, Cm, all float32."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T, H, P)) * 0.5).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, T, H)), 0.0).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm = (rng.standard_normal((B, T, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, T, N)) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm


def _inputs(case, seed=2, bc_dtype="float32"):
    """``ssd_arrays`` as (jax, torch) pairs, B and C in ``bc_dtype``."""
    x, dt, A, Bm, Cm = ssd_arrays(*case[:5], seed)
    out = [(jnp.asarray(a), torch.from_numpy(a)) for a in (x, dt, A)]
    jdt = jnp.bfloat16 if bc_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if bc_dtype == "bfloat16" else torch.float32
    out += [(jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt))
            for a in (Bm, Cm)]
    return out


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_ref_matches_reference(case):
    pairs = _inputs(case)
    yj, sj = jax.jit(jax_ssd_ref)(*(j for j, _ in pairs))
    yt, st = ssd_ref(*(t for _, t in pairs))
    _close(yt, yj, 1e-5)
    _close(st, sj, 1e-5)


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_scan_matches_pallas_interpret(case):
    """The wrapper (on the CPU: the plain chunked version) against the
    Pallas kernel in interpret mode, float32, at the reference's 2e-3."""
    pairs = _inputs(case, seed=5)
    chunk = case[-1]
    yj, sj = jax_ops.ssd_scan(*(j for j, _ in pairs), chunk=chunk)
    yt, st = ops.ssd_scan(*(t for _, t in pairs), chunk=chunk)
    assert yt.dtype == st.dtype == torch.float32
    _close(yt, yj, 2e-3)
    _close(st, sj, 2e-3)


@pytest.mark.parametrize("case", [SSD_CASES[0], SSD_CASES[2]], ids=str)
def test_kernel_plain_version_matches_recurrence_bf16_bc(case):
    """The wrapper on the CPU (the chunked plain version) against the
    token-by-token recurrence, with B and C in bfloat16 as a bf16 model
    gives them."""
    x, dt, A, Bm, Cm = (t for _, t in _inputs(case, seed=7,
                                              bc_dtype="bfloat16"))
    y, s = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=case[-1])
    yr, sr = ssd_ref(x, dt, A, Bm, Cm)
    torch.testing.assert_close(y, yr, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(s, sr, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("T", [64, 128, 200, 250, 257, 512, 1000])
def test_default_chunk_matches_reference(T):
    """The reference's choice on an empty autotune cache."""
    assert ops.DEFAULT_CHUNK == 128
    assert (ops._largest_dividing_chunk(T, ops.DEFAULT_CHUNK)
            == jax_ops._largest_dividing_chunk(T, 128))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, dt, A, Bm, Cm = (t for _, t in _inputs((1, 128, 2, 32, 16, 64)))
    with pytest.raises(ValueError, match="dtype"):
        ops.ssd_scan(x, dt, A, Bm.half(), Cm.half(), chunk=64)
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=48)
    with pytest.raises(ValueError, match="head_dim"):
        ops.ssd_scan(x[..., :16], dt, A, Bm, Cm, chunk=64)
    with pytest.raises(ValueError, match="disagree"):
        ops.ssd_scan(x, dt[:, :64], A, Bm, Cm, chunk=64)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_scan(x, dt, A, Bm.transpose(1, 2).contiguous().transpose(1, 2),
                     Cm, chunk=64)
    with pytest.raises(ValueError, match="device"):
        ops.ssd_scan(x.to("meta"), dt.to("meta"), A.to("meta"),
                     Bm.to("meta"), Cm.to("meta"), chunk=64)
