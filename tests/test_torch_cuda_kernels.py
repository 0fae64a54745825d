"""The CUDA kernels against their plain PyTorch versions on the GPU, over
the reference's case lists: 2e-5 in float32, 2e-2 in bfloat16.

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
