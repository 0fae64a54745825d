"""Port flash-attention kernel: plain version and wrapper against the JAX
package, and the wrappers' dispatch.

The same numpy inputs go through the reference (``repro.kernels.*``: the
jnp oracle, and the Pallas kernel in interpret mode) and the port's plain
PyTorch version, at the reference's tolerances: 2e-5 in float32, 2e-2 in
bfloat16.  Decode attention is in test_torch_decode_kernels.py; the CUDA
kernels' own tests, which need a GPU, in test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import \
    flash_attention as jax_pallas_flash  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as _jax_attention_ref  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

# a copy of the reference's case list (tests/test_kernels.py)
FLASH_CASES = [
    # (B, Tq, Tk, H, KV, hd, causal, window, cap)
    (2, 256, 256, 8, 2, 64, True, None, None),
    (1, 128, 128, 4, 4, 32, True, 64, None),
    (2, 200, 200, 6, 2, 64, True, None, 50.0),     # padding path
    (1, 256, 256, 8, 1, 128, True, 100, 30.0),     # MQA + window + cap
    (1, 96, 96, 8, 8, 32, False, None, None),      # bidirectional (encoder)
    (3, 384, 384, 15, 5, 64, True, None, None),    # smollm-like heads
    (2, 200, 200, 6, 2, 64, False, None, None),    # non-causal k-padding
]
jax_attention_ref = jax.jit(_jax_attention_ref,
                            static_argnames=("causal", "window", "logit_cap"))
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, shapes, dtype):
    """Seeded numpy arrays as (jax, torch) pairs, rounded to `dtype` the
    same way (round-to-nearest-even from float32) on both sides."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    out = []
    for shp in shapes:
        x = (rng.standard_normal(shp) * 0.5).astype(np.float32)
        out.append((jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)))
    return out


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_flash_matches_reference(case, dtype):
    B, Tq, Tk, H, KV, hd, causal, window, cap = case
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        0, [(B, Tq, H, hd), (B, Tk, KV, hd), (B, Tk, KV, hd)], dtype)
    kw = dict(causal=causal, window=window, logit_cap=cap)
    _close(attention_ref(qt, kt, vt, **kw), jax_attention_ref(qj, kj, vj, **kw),
           DTYPES[dtype][2])


@pytest.mark.parametrize("case", [FLASH_CASES[5], FLASH_CASES[3]], ids=str)
def test_flash_wrapper_matches_pallas_interpret(case):
    """The smollm-like case and the windowed + capped one against the
    Pallas kernel itself (interpret mode on the CPU), float32."""
    B, Tq, Tk, H, KV, hd, causal, window, cap = case
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        3, [(B, Tq, H, hd), (B, Tk, KV, hd), (B, Tk, KV, hd)], "float32")
    kw = dict(causal=causal, window=window, logit_cap=cap)
    _close(flash_ops.flash_attention(qt, kt, vt, **kw),
           jax_pallas_flash(qj, kj, vj, **kw), 2e-5)


def test_cpu_tensors_take_the_plain_version():
    (_, qt), (_, kt), (_, vt) = _inputs(
        5, [(2, 40, 6, 32), (2, 40, 2, 32), (2, 40, 2, 32)], "float32")
    assert torch.equal(flash_ops.flash_attention(qt, kt, vt, window=16),
                       attention_ref(qt, kt, vt, window=16))
    q1 = qt[:, 0].contiguous()
    assert torch.equal(dec_ops.decode_attention(q1, kt, vt, 20),
                       decode_attention_ref(q1, kt, vt, 20))


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "mixed_dtype",
                                 "grouping", "device"])
def test_unsupported_inputs_raise(bad):
    B, T, H, KV, hd = 1, 16, 4, 2, 32
    q = torch.zeros(B, T, H, hd)
    k = torch.zeros(B, T, KV, hd)
    v = torch.zeros(B, T, KV, hd)
    if bad == "head_dim":
        q, k, v = q[..., :12], k[..., :12], v[..., :12]
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed_dtype":
        k = k.bfloat16()
    elif bad == "grouping":
        q = torch.zeros(B, T, 3, hd)
    else:
        q, k, v = (x.to("meta") for x in (q, k, v))
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, k, v)
    kc, vc = k.transpose(1, 2), v.transpose(1, 2)
    with pytest.raises(ValueError):
        dec_ops.decode_attention_kvmajor(q[:, 0].contiguous(), kc, vc, 3)
