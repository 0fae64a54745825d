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
    """Off the CPU (a meta tensor: checked before any device is touched)
    the kernel's limits raise; a chunk that does not divide T and shapes
    that disagree raise on the CPU too, as in the reference."""
    x, dt, A, Bm, Cm = (t for _, t in _inputs((1, 128, 2, 32, 16, 64)))
    xm, dtm, Am, Bmm, Cmm = (t.to("meta") for t in (x, dt, A, Bm, Cm))
    with pytest.raises(ValueError, match="dtype"):
        ops.ssd_scan(xm, dtm, Am, Bmm.half(), Cmm.half(), chunk=64)
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=48)
    with pytest.raises(ValueError, match="head_dim"):
        ops.ssd_scan(xm[..., :16], dtm, Am, Bmm, Cmm, chunk=64)
    with pytest.raises(ValueError, match="disagree"):
        ops.ssd_scan(x, dt[:, :64], A, Bm, Cm, chunk=64)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_scan(xm, dtm, Am,
                     Bmm.transpose(1, 2).contiguous().transpose(1, 2), Cmm,
                     chunk=64)
    with pytest.raises(ValueError, match="device"):
        ops.ssd_scan(xm, dtm, Am, Bmm, Cmm, chunk=64)


def test_ssd_launcher_constants_match_the_cuda_source():
    """The tile, the heads per output block and the launches per call the
    launcher and the autotuner count by without a built library are the
    CUDA source's.  On the card ``_lib`` holds them against the library
    too."""
    import re
    from pathlib import Path

    from repro_torch.kernels.ssd_scan import ssd_scan as k4
    src = (Path(k4.__file__).resolve().parents[1] / "csrc"
           / "ssd_scan.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["TILE"]) == k4.TILE == 64
    assert int(consts["HG"]) == k4.HEADS_PER_BLOCK
    assert int(consts["KS"]) == k4.SLICE_ROWS
    assert int(consts["STAGES1"]) == k4.SLICE_STAGES
    assert len(re.findall(r"<<<", src)) == k4.KERNELS_PER_CALL == 2
    assert re.search(r"out\[2\] = (\d+);", src).group(1) == "2"
    # the Mamba2 shape's blocks fit a block's 227 KB, at the longest chunk
    for size in (2, 4):
        for chunk in (256, 1024):
            assert k4.smem_bytes(size, size, 64, 128, chunk) <= 232_448


@pytest.mark.parametrize("bad,match", [
    ("x_dtype", "x/dt/A dtype"), ("dt_dtype", "x/dt/A dtype"),
    ("A_dtype", "x/dt/A dtype"), ("x_last", "contiguous"),
    ("A_strided", "contiguous"), ("A_shape", "disagree"),
], ids=str)
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_wrapper_checks_x_dt_and_a(bad, match, device):
    """Off the CPU: x in float32 or bf16 with a contiguous last dim, dt and
    A in float32, A contiguous and (H,), what the kernel reads in place;
    checked before any device is touched (a meta tensor).  On the CPU only
    A's shape is checked, as the reference takes the rest: the plain
    version gives what it gives on float32 contiguous copies."""
    x, dt, A, Bm, Cm = (t.to(device) for _, t in
                        _inputs((1, 128, 2, 32, 16, 64)))
    if bad == "x_dtype":
        x = x.half()
    elif bad == "dt_dtype":
        dt = dt.double()
    elif bad == "A_dtype":
        A = A.bfloat16()
    elif bad == "x_last":
        x = x.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif bad == "A_strided":
        A = torch.stack([A, A], dim=-1)[:, 0]
    else:
        A = A[:1]
    if device == "meta" or bad == "A_shape":
        with pytest.raises(ValueError, match=match):
            ops.ssd_scan(x, dt, A, Bm, Cm, chunk=64)
        return
    y, s = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=64)
    yr, sr = ops.ssd_scan(*(t.float().contiguous() for t in (x, dt, A)),
                          Bm, Cm, chunk=64)
    torch.testing.assert_close(y, yr, atol=0, rtol=0)
    torch.testing.assert_close(s, sr, atol=0, rtol=0)


def test_wrapper_takes_x_as_a_strided_slice_on_the_cpu():
    """x as the model passes it: a slice of the convolution's output, here
    with a bf16 x; the same result as a contiguous copy."""
    x, dt, A, Bm, Cm = (t for _, t in _inputs((2, 128, 4, 32, 16, 64)))
    xb = x.bfloat16()
    wide = torch.cat([xb.flatten(2), torch.zeros(2, 128, 16,
                                                 dtype=torch.bfloat16)], -1)
    view = wide[..., :128].unflatten(-1, (4, 32))
    for got, want in zip(ops.ssd_scan(view, dt, A, Bm, Cm, chunk=64),
                         ops.ssd_scan(xb.contiguous(), dt, A, Bm, Cm,
                                      chunk=64)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
