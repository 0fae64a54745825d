"""The port's differentiable blockwise attention (``layers._Flash``) against
``jax.vjp`` of the reference's ``repro.models.layers.flash_attention``
(its custom VJP), on the same seeded numpy inputs and cotangent.

Tolerances: float32, the output and dq / dk / dv within 2e-5 of the
largest of each; bfloat16, within twice the reference's own gap between
its bfloat16 and float32 results on the same (bfloat16-rounded) inputs.
The forward also equals, bit for bit, the plain forward the port had
before it became differentiable (``_forward_before``), which the flash
kernel is held against on the card."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from test_torch_train_models import one_torch_thread  # noqa: E402,F401

CASES = {
    # name: (B, Tq, Tk, H, KV, hd, kwargs); blocks given explicitly
    "causal_g1": (2, 64, 64, 4, 4, 16,
                  dict(causal=True, block_q=16, block_k=32)),
    "bidirectional_g3_ragged": (1, 50, 50, 6, 2, 16,
                                dict(causal=False, block_q=16, block_k=16)),
    "window": (1, 48, 48, 6, 2, 16,
               dict(causal=True, window=12, block_q=16, block_k=16)),
    "cap": (2, 40, 40, 3, 1, 32,
            dict(causal=True, logit_cap=5.0, block_q=16, block_k=16)),
    "q_offset": (1, 24, 56, 4, 4, 16,
                 dict(causal=True, q_offset=32, block_q=16, block_k=16)),
    "kv_valid_len": (2, 40, 48, 6, 2, 16,
                     dict(causal=False, kv_valid_len=37, block_q=16,
                          block_k=16)),
    "cross_tq_ne_tk": (2, 20, 70, 6, 2, 16,
                       dict(causal=False, block_q=16, block_k=32)),
    "window_cap_g3": (1, 72, 72, 6, 2, 32,
                      dict(causal=True, window=20, logit_cap=8.0,
                           block_q=32, block_k=16)),
}


def _arrays(case, seed=0):
    B, Tq, Tk, H, KV, hd, _ = CASES[case]
    rng = np.random.default_rng(seed)
    # q and k at scale 1.5: peaked softmax rows, so a masking or
    # rescaling error moves the output by O(|v|)
    q = (rng.standard_normal((B, Tq, H, hd)) * 1.5).astype(np.float32)
    k = (rng.standard_normal((B, Tk, KV, hd)) * 1.5).astype(np.float32)
    v = rng.standard_normal((B, Tk, KV, hd)).astype(np.float32)
    do = rng.standard_normal((B, Tq, H, hd)).astype(np.float32)
    return q, k, v, do


def _round(x, dtype):
    """numpy float32 rounded to ``dtype`` (as torch rounds), as float32."""
    return torch.from_numpy(x).to(dtype).float().numpy()


def _reference(case, arrays, jdt):
    kw = CASES[case][-1]
    q, k, v, do = (jnp.asarray(a).astype(jdt) for a in arrays)
    out, vjp = jax.vjp(lambda q, k, v: jlayers.flash_attention(q, k, v, **kw),
                       q, k, v)
    return [np.asarray(x, np.float32) for x in (out, *vjp(do))]


def _port(case, arrays, tdt):
    kw = CASES[case][-1]
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in arrays)
    for t in (q, k, v):
        t.requires_grad_(True)
    out = layers.flash_attention(q, k, v, **kw)
    grads = torch.autograd.grad(out, (q, k, v), do)
    return [x.detach().float().numpy() for x in (out, *grads)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_vjp_matches_reference_f32(case):
    arrays = _arrays(case)
    want = _reference(case, arrays, jnp.float32)
    got = _port(case, arrays, torch.float32)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        err = np.abs(g - w).max()
        assert err <= 2e-5 * np.abs(w).max(), (name, err, np.abs(w).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_vjp_matches_reference_bf16(case):
    arrays = [_round(a, torch.bfloat16) for a in _arrays(case)]
    want = _reference(case, arrays, jnp.bfloat16)
    floor = _reference(case, arrays, jnp.float32)
    got = _port(case, arrays, torch.bfloat16)
    for name, g, w, f in zip(("out", "dq", "dk", "dv"), got, want, floor):
        gap = np.abs(w - f).max()
        assert gap > 0, name
        err = np.abs(g - w).max()
        assert err <= 2 * gap, (name, err, gap)


def _forward_before(q, k, v, *, causal=True, window=None, logit_cap=None,
                    q_offset=0, kv_valid_len=None, block_q=256, block_k=512):
    """The port's plain forward as it was before its custom backward, with
    explicit blocks, kept here to pin the forward bit for bit."""
    B, Tq, H, hd = q.shape
    _, Tk, KV, _ = k.shape
    G = H // KV
    block_q = min(block_q, max(Tq, 1))
    block_k = min(block_k, max(Tk, 1))
    qp = layers._pad_axis(q, 1, block_q)
    kp = layers._pad_axis(k, 1, block_k)
    vp = layers._pad_axis(v, 1, block_k)
    nq = qp.shape[1] // block_q
    nk = kp.shape[1] // block_k
    qp = qp.reshape(B, nq, block_q, KV, G, hd)
    kp = kp.reshape(B, nk, block_k, KV, hd).float()
    vp = vp.reshape(B, nk, block_k, KV, hd)
    kv_len = Tk if kv_valid_len is None else kv_valid_len
    scale = hd ** -0.5
    outs = []
    for qi in range(nq):
        qblk = (qp[:, qi] * scale).float()
        qpos = q_offset + qi * block_q + torch.arange(block_q)
        m = torch.full((B, KV, G, block_q), layers.NEG_INF)
        l = torch.zeros((B, KV, G, block_q))
        acc = torch.zeros((B, block_q, KV, G, hd))
        for ki in range(nk):
            kpos = ki * block_k + torch.arange(block_k)
            s = layers.softcap(torch.einsum("bqkgd,bskd->bkgqs", qblk,
                                            kp[:, ki]), logit_cap)
            mask = layers._mask_for(qpos, kpos, causal, window, kv_len)
            s = torch.where(mask, s, torch.full_like(s, layers.NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(),
                              vp[:, ki].float())
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        l = torch.clamp(l, min=1e-30)
        outs.append((acc / l.permute(0, 3, 1, 2)[..., None]).to(q.dtype))
    out = torch.stack(outs, dim=1).reshape(B, nq * block_q, H, hd)
    return out[:, :Tq]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_unchanged_bit_for_bit(case, dtype):
    kw = CASES[case][-1]
    q, k, v, _ = (torch.from_numpy(a).to(dtype) for a in _arrays(case, 1))
    assert torch.equal(layers.flash_attention(q, k, v, **kw),
                       _forward_before(q, k, v, **kw))
    with torch.no_grad():      # the serving path: no graph is recorded
        assert torch.equal(layers.flash_attention(q, k, v, **kw),
                           _forward_before(q, k, v, **kw))
