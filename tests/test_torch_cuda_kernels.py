"""The CUDA kernels against their plain PyTorch versions on the GPU, over
the reference's case lists: attention at 2e-5 in float32 and 2e-2 in
bfloat16; the SSD scan at the reference's 2e-3, with float32 or bfloat16
B/C, over its case list and the Mamba2 and Zamba2 serving shapes.

Marked ``cuda``: each test skips without a GPU.  This file imports no JAX,
so it runs on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.mamba import ssd_chunked

# copies of the reference's case lists (tests/test_kernels.py,
# tests/test_paged_attention.py)
FLASH_CASES = [
    # (B, Tq, Tk, H, KV, hd, causal, window, cap)
    (2, 256, 256, 8, 2, 64, True, None, None),
    (1, 128, 128, 4, 4, 32, True, 64, None),
    (2, 200, 200, 6, 2, 64, True, None, 50.0),
    (1, 256, 256, 8, 1, 128, True, 100, 30.0),
    (1, 96, 96, 8, 8, 32, False, None, None),
    (3, 384, 384, 15, 5, 64, True, None, None),
    (2, 200, 200, 6, 2, 64, False, None, None),
    (1, 64, 64, 8, 4, 256, True, 32, 50.0),        # gemma2's head_dim
]
DECODE_CASES = [
    # (B, S, H, KV, hd, pos, window, cap)
    (2, 512, 8, 2, 64, 300, None, None),
    (1, 512, 4, 1, 128, 511, 128, None),
    (3, 300, 6, 6, 32, 150, None, 50.0),
    (2, 1024, 48, 1, 64, 700, None, None),
    (1, 256, 32, 4, 128, 0, None, None),
    (2, 300, 8, 2, 64, 299, None, None),
    (3, 300, 6, 3, 64, 150, None, None),
    (1, 512, 4, 1, 128, 37, None, None),
    (1, 640, 12, 3, 64, 633, 128, None),
    (2, 384, 10, 5, 32, 65, None, 40.0),
    (1, 256, 8, 2, 64, 0, None, None),
]
DTYPES = {"float32": (torch.float32, 2e-5), "bfloat16": (torch.bfloat16, 2e-2)}
SSD_CASES = [
    # (B, T, H, P, N, chunk): the reference's, then the serving shapes of
    # Mamba2-1.3B and Zamba2-1.2B (8 prompts of 512 tokens)
    (2, 256, 4, 64, 32, 64),
    (1, 128, 8, 32, 16, 128),
    (2, 512, 2, 64, 64, 128),
    (1, 256, 64, 64, 128, 64),
    (8, 512, 64, 64, 128, 256),
    (8, 512, 64, 64, 64, 256),
    # the chunks 300- and 700-token prompts give (300, 350): not multiples
    # of the kernel's 64-row tile
    (2, 300, 8, 64, 128, 300),
    (1, 700, 4, 32, 64, 350),
]


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels need an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, shapes, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(s) * 0.5).astype(np.float32))
            .to(device, DTYPES[dtype][0]) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_matches_plain(gpu, case, dtype):
    B, Tq, Tk, H, KV, hd, causal, window, cap = case
    q, k, v = _inputs(0, [(B, Tq, H, hd), (B, Tk, KV, hd), (B, Tk, KV, hd)],
                      dtype, gpu)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    out = flash_ops.flash_attention(q, k, v, **kw)
    tol = DTYPES[dtype][1]
    torch.testing.assert_close(out.float(), attention_ref(q, k, v, **kw).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["bskd", "kvmajor"])
def test_decode_kernel_matches_plain(gpu, case, dtype, layout):
    B, S, H, KV, hd, pos, window, cap = case
    q, k, v = _inputs(1, [(B, H, hd), (B, S, KV, hd), (B, S, KV, hd)],
                      dtype, gpu)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=gpu)
    kw = dict(window=window, logit_cap=cap)
    if layout == "kvmajor":
        out = dec_ops.decode_attention_kvmajor(
            q, k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
            pos_t, **kw)
    else:
        out = dec_ops.decode_attention(q, k, v, pos_t, **kw)
    tol = DTYPES[dtype][1]
    torch.testing.assert_close(
        out.float(), decode_attention_ref(q, k, v, pos, **kw).float(),
        atol=tol, rtol=tol)


@pytest.mark.cuda
def test_unsupported_cuda_input_raises(gpu):
    q = torch.zeros(1, 8, 4, 32, device=gpu, dtype=torch.float16)
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, q[:, :, :2], q[:, :, :2])


def ssd_inputs(case, bc_dtype, device, seed=2):
    """The reference test's distributions, drawn with numpy: x, dt
    (softplus'd), A (negative), Bm, Cm."""
    B, T, H, P, N, _ = case
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(device)

    x = normal(B, T, H, P, scale=0.5)
    dt = torch.nn.functional.softplus(normal(B, T, H))
    A = -torch.exp(normal(H, scale=0.5))
    Bm = normal(B, T, N, scale=0.5).to(bc_dtype)
    Cm = normal(B, T, N, scale=0.5).to(bc_dtype)
    return x, dt, A, Bm, Cm


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_kernel_matches_plain(gpu, case, bc_dtype):
    x, dt, A, Bm, Cm = ssd_inputs(case, bc_dtype, gpu)
    chunk = case[-1]
    y, state = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    y_ref, s_ref = ssd_chunked(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(state, s_ref, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
def test_ssd_kernel_takes_strided_bc(gpu):
    """B and C as the model passes them: slices of one (B, T, C) tensor."""
    case = (2, 256, 8, 64, 64, 128)
    x, dt, A, Bm, Cm = ssd_inputs(case, torch.bfloat16, gpu)
    xbc = torch.cat([torch.zeros_like(Bm), Bm, Cm], dim=-1)
    N = Bm.shape[-1]
    y1, s1 = ssd_ops.ssd_scan(x, dt, A, xbc[..., N:2 * N], xbc[..., 2 * N:],
                              chunk=128)
    y2, s2 = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=128)
    torch.testing.assert_close(y1, y2, atol=0, rtol=0)
    torch.testing.assert_close(s1, s2, atol=0, rtol=0)


@pytest.mark.cuda
def test_ssd_unsupported_cuda_input_raises(gpu):
    x, dt, A, Bm, Cm = ssd_inputs((1, 128, 2, 32, 16, 64), torch.float32, gpu)
    with pytest.raises(ValueError, match="dtype"):
        ssd_ops.ssd_scan(x, dt, A, Bm.half(), Cm.half(), chunk=64)
    with pytest.raises(ValueError, match="chunk"):
        ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=48)
    with pytest.raises(ValueError, match="devices"):
        ssd_ops.ssd_scan(x, dt, A, Bm.cpu(), Cm, chunk=64)
    with pytest.raises(ValueError, match="head_dim"):
        ssd_ops.ssd_scan(x[..., :16], dt, A, Bm, Cm, chunk=64)
