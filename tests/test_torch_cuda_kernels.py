"""The CUDA kernels against their plain PyTorch versions on the GPU, over
the reference's case lists: attention (flash, split-K decode, paged
decode) at 2e-5 in float32 and 2e-2 in bfloat16, the flash kernel's wgmma
body also over its own cases, each asserting which body ran, and the two
decode kernels at G 48, past a full cluster of splits and as one launch
that allocates only its output (the paged one also on a pool view off the
16-byte rule); the SSD scan
at the reference's 2e-3, with float32 or bfloat16 B/C, over its case list
and the Mamba2 and Zamba2 serving shapes.  The autotuner on the card times
the flash kernel at each wgmma tile and the paged kernel at every page
size.

Marked ``cuda``: each test skips without a GPU.  This file imports no JAX,
so it runs on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import \
    paged_decode_attention as paged_kernel
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref)
from repro_torch.kernels.flash_attention import \
    flash_attention as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import layers
from repro_torch.models.mamba import ssd_chunked
from repro_torch.perf import autotune

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
    (2, 1500, 16, 16, 64, 1499, None, None),   # Whisper's cross-attention
    (1, 1024, 8, 4, 256, 512, None, 50.0),     # gemma2's decode step
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


# cases of the flash kernel's wgmma body (bf16, head_dim 64 and 128):
# (B, Tq, Tk, H, KV, hd, causal, window, cap, q_offset, block_q, block_k)
WGMMA_CASES = (
    # each tile, at hd 64 (G 4) and with window and cap at hd 128 (G 8)
    [(2, 256, 256, 8, 2, 64, True, None, None, 0, bq, bk)
     for bq in (64, 128) for bk in (64, 128)]
    + [(1, 256, 256, 8, 1, 128, True, 100, 30.0, 0, bq, bk)
       for bq in (64, 128) for bk in (64, 128)]
    + [(2, 200, 200, 6, 6, 64, True, None, None, 0, 128, 64),     # Tq 200, G 1
       (3, 384, 384, 15, 5, 128, True, None, None, 0, 128, 128),  # Tq 384, G 3
       (2, 100, 300, 8, 8, 64, True, None, None, 200, 64, 128),   # Tk > Tq
       (2, 130, 400, 16, 2, 128, True, None, 50.0, 270, 128, 64),
       (2, 200, 200, 6, 2, 64, False, None, None, 0, 64, 64),     # bidirectional
       (2, 384, 384, 6, 2, 64, True, 64, None, 0, None, None),    # default tile
       # Whisper's encoder (1500 frames: ragged at both tiles on both
       # sides) and its prefill cross-attention (Tq 200 against Tk 1500),
       # bidirectional, G 1; InternVL2's G 2 at hd 128
       (1, 1500, 1500, 4, 4, 64, False, None, None, 0, None, None),
       (2, 200, 1500, 4, 4, 64, False, None, None, 0, 128, 128),
       (2, 512, 512, 16, 8, 128, True, None, None, 0, None, None)])
# head_dim 256 at both of its tiles (64-key only): the CPU tests'
# FLASH_256_CASES (tests/test_torch_kernels.py; Gemma-2-2B's G 2 and cap 50:
# a window of 32 cutting the tiles, Tq 100, q_offset with Tk > Tq), then
# G 1 and G 8, and Gemma-2-2B's prefill call itself (8 x 512, H 8, KV 4)
WGMMA_256_CASES = [
    case + (bq, bk) for bq, bk in ((64, 64), (128, 64)) for case in (
        (1, 192, 192, 4, 2, 256, True, 32, 50.0, 0),
        (2, 100, 100, 4, 2, 256, True, None, 50.0, 0),
        (1, 70, 200, 4, 2, 256, True, 128, 50.0, 130),
        (2, 200, 200, 4, 4, 256, True, None, 50.0, 0),
        (1, 256, 256, 8, 1, 256, True, 100, None, 0),
        (8, 512, 512, 8, 4, 256, True, None, 50.0, 0))]


def _bodies_run(fn):
    """The flash bodies ``fn`` launched, by ``LAUNCHES_BY_BODY``."""
    before = dict(flash_kernel.LAUNCHES_BY_BODY)
    out = fn()
    torch.cuda.synchronize()
    return out, {n: c - before[n] for n, c in
                 flash_kernel.LAUNCHES_BY_BODY.items() if c != before[n]}


@pytest.mark.cuda
@pytest.mark.parametrize("case", WGMMA_CASES + WGMMA_256_CASES, ids=str)
def test_flash_wgmma_body_matches_plain(gpu, case):
    """q and k at scale 2, so the softmax is peaked and a masking or layout
    error shows at 2e-2."""
    B, Tq, Tk, H, KV, hd, causal, window, cap, q_offset, bq, bk = case
    q, k, v = _inputs(4, [(B, Tq, H, hd), (B, Tk, KV, hd), (B, Tk, KV, hd)],
                      "bfloat16", gpu)
    q, k = q * 4, k * 4
    kw = dict(causal=causal, window=window, logit_cap=cap, q_offset=q_offset)
    out, ran = _bodies_run(lambda: flash_ops.flash_attention(
        q, k, v, block_q=bq, block_k=bk, **kw))
    assert ran == {"wgmma": 1}
    torch.testing.assert_close(out.float(),
                               attention_ref(q, k, v, **kw).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("broken", ["pointer", "strides", "strides_hd256"])
def test_flash_view_off_the_16_byte_rule_takes_the_cuda_core_body(gpu,
                                                                   broken):
    """A bf16 view at head_dim 64 (or 256) whose pointers sit 8 bytes off
    a 16-byte boundary, or whose strides are not multiples of 16 bytes, is
    read by neither TMA nor the mma.sync body's 16-byte loads."""
    B, T, H, KV, hd = 2, 200, 6, 2, 256 if broken == "strides_hd256" else 64
    pad = 8 if broken == "pointer" else 4
    q, k, v = _inputs(5, [(B, T, H, hd + pad), (B, T, KV, hd + pad),
                          (B, T, KV, hd + pad)], "bfloat16", gpu)
    lo = 4 if broken == "pointer" else 0
    q, k, v = (x[..., lo:lo + hd] for x in (q, k, v))
    out, ran = _bodies_run(lambda: flash_ops.flash_attention(q, k, v))
    assert ran == {"cuda_cores": 1}
    torch.testing.assert_close(out.float(),
                               attention_ref(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tile,error", [
    ("bfloat16", (32, 64), ValueError),      # no body has it
    ("bfloat16", (21, 64), RuntimeError),    # the wgmma body lacks it
    ("float32", (128, 128), RuntimeError),   # the CUDA-core body lacks it
    ("bfloat16", (64, 128, 256), ValueError),   # no 128-key tile at hd 256
], ids=str)
def test_flash_tile_the_body_lacks_raises_without_a_launch(gpu, dtype, tile,
                                                           error):
    """(block_q, block_k[, head_dim]); at head_dim 256 the launcher, called
    past the wrapper's check, refuses the tile too."""
    hd = tile[2] if len(tile) > 2 else 64
    q, k, v = _inputs(6, [(1, 64, 6, hd), (1, 64, 2, hd), (1, 64, 2, hd)],
                      dtype, gpu)
    before = flash_kernel.LAUNCHES
    with pytest.raises(error, match="tile"):
        flash_ops.flash_attention(q, k, v, block_q=tile[0], block_k=tile[1])
    if hd == 256:
        with pytest.raises(RuntimeError, match="tile"):
            flash_kernel.flash_attention_fwd(
                q, k, v, causal=True, window=None, logit_cap=None,
                block_q=tile[0], block_k=tile[1])
    assert flash_kernel.LAUNCHES == before


@pytest.mark.cuda
def test_tune_flash_times_each_wgmma_tile_through_the_kernel(gpu, tmp_path):
    prev = autotune._state["cache_dir"]
    autotune.configure(cache_dir=str(tmp_path))
    try:
        dims = dict(BKV=4, G=3, hd=64, Tq=256, Tk=256, causal=True)
        before = flash_kernel.LAUNCHES_BY_BODY["wgmma"]
        e = autotune.tune("flash_attention", "bfloat16", device=gpu, **dims)
        torch.cuda.synchronize()
        assert sorted(json.loads(c)["block_q"] * 1000 + json.loads(c)["block_k"]
                      for c in e["candidates_timed"]) == \
            [64064, 64128, 128064, 128128]
        assert flash_kernel.LAUNCHES_BY_BODY["wgmma"] - before == \
            4 * (1 + autotune.GRAPH_CALLS)
        q, k = _inputs(7, [(4, 256, 3, 64), (4, 256, 1, 64)], "bfloat16", gpu)
        assert flash_ops._resolve_tile(None, None, q, k, True) == \
            (e["config"]["block_q"], e["config"]["block_k"])
    finally:
        autotune._state["cache_dir"] = prev
        autotune.configure(tune_on_miss=False)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(64, 64), (64, 128), (128, 64), (128, 128)],
                         ids=str)
def test_flash_kernel_matches_plain_at_the_tuned_class(gpu, tile):
    """The inputs the autotuner times K1 on for SmolLM-360M's batch-8
    prefill class (BKV 64, G 3, hd 64, T 512, causal), in bfloat16, at each
    tile it times."""
    cls = autotune.shape_class("flash_attention", BKV=40, G=3, hd=64,
                               Tq=512, Tk=512, causal=True)
    q, k, v = autotune.flash_inputs(cls, torch.bfloat16, gpu)
    out, ran = _bodies_run(lambda: flash_ops.flash_attention(
        q, k, v, causal=True, block_q=tile[0], block_k=tile[1]))
    assert ran == {"wgmma": 1}
    torch.testing.assert_close(out.float(),
                               attention_ref(q, k, v, causal=True).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(128, 64), (64, 128), (128, 128)], ids=str)
def test_flash_tuned_tile_reaches_the_wgmma_body_only(gpu, tmp_path, tile):
    """A tuned wgmma tile is taken by the aligned calls of its class; a view
    of the same class off the 16-byte rule runs the CUDA-core body at its
    own tile instead of raising."""
    prev = autotune._state["cache_dir"]
    autotune.configure(cache_dir=str(tmp_path))
    try:
        B, T, H, KV, hd = 2, 256, 6, 2, 64
        dims = dict(BKV=B * KV, G=H // KV, hd=hd, Tq=T, Tk=T, causal=True)
        cls = autotune.shape_class("flash_attention", **dims)
        key = autotune._key("flash_attention", autotune.backend_key(gpu),
                            "bfloat16", cls)
        autotune._load()[key] = {"config": {"block_q": tile[0],
                                            "block_k": tile[1]}}
        autotune.configure()                      # clears the lookup memo
        q, k, v = _inputs(8, [(B, T, H, hd + 4), (B, T, KV, hd + 4),
                              (B, T, KV, hd + 4)], "bfloat16", gpu)
        assert flash_ops._resolve_tile(None, None, q[..., :hd], k[..., :hd],
                                       True) == tile
        for lo, body in ((0, "wgmma"), (4, "cuda_cores")):
            if lo:
                qv, kv, vv = (x[..., lo:lo + hd] for x in (q, k, v))
            else:
                qv, kv, vv = (x[..., :hd].contiguous() for x in (q, k, v))
            out, ran = _bodies_run(
                lambda: flash_ops.flash_attention(qv, kv, vv))
            assert ran == {body: 1}
            torch.testing.assert_close(out.float(),
                                       attention_ref(qv, kv, vv).float(),
                                       atol=2e-2, rtol=2e-2)
    finally:
        autotune._state["cache_dir"] = prev
        autotune.configure(tune_on_miss=False)


@pytest.mark.cuda
def test_flash_launcher_constants_match_the_library(gpu):
    """The launcher's wgmma tiles, default tile, stages and shared-memory
    prices are the built library's (``_lib`` raises where they differ)."""
    lib = flash_kernel._lib()
    flash_kernel._check_config(lib)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["bskd", "kvmajor", "kvmajor_view"])
def test_decode_kernel_matches_plain(gpu, case, dtype, layout):
    """``kvmajor_view``: the kv-major wrapper on the transposed view of a
    (B, S, KV, hd) cache, as a decode step's cross-attention reads the
    encoder's K/V."""
    B, S, H, KV, hd, pos, window, cap = case
    q, k, v = _inputs(1, [(B, H, hd), (B, S, KV, hd), (B, S, KV, hd)],
                      dtype, gpu)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=gpu)
    kw = dict(window=window, logit_cap=cap)
    if layout == "kvmajor_view":
        out = dec_ops.decode_attention_kvmajor(
            q, k.transpose(1, 2), v.transpose(1, 2), pos_t, **kw)
    elif layout == "kvmajor":
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


# (B, S, H, KV, hd, page_size, lens, window, cap): the reference's
# PAGED_CASES (tests/test_paged_attention.py), each page size the autotuner
# offers, and the two timing shapes of chip_smoke.py: SmolLM-360M's decode
# geometry with every slot full, and the ragged shape of
# benchmarks/token_benches.py
PAGED_CASES = [
    (4, 512, 8, 2, 64, 64, (512, 300, 37, 1), None, None),
    (1, 256, 4, 1, 128, 64, (200,), None, None),
    (3, 384, 6, 3, 64, 128, (384, 129, 64), None, None),
    (2, 512, 8, 2, 64, 64, (500, 90), 128, None),
    (2, 256, 4, 4, 32, 32, (250, 31), None, 50.0),
    (3, 256, 8, 2, 64, 64, (256, 0, 10), None, None),
]
PAGE_SIZE_CASES = [(2, 512, 8, 2, 64, psz, (512, 301), None, None)
                   for psz in (32, 64, 128, 256)]
PAGED_TIMING_CASES = [
    (8, 544, 15, 5, 64, 32, (544,) * 8, None, None),
    (8, 1024, 8, 2, 64, 64, (1024, 700, 512, 301, 128, 37, 1, 0), None, None),
]


def paged_inputs(case, dtype, device, *, shuffle=True, seed=5):
    """q, the dense cache chopped into a (P, psz, KV, hd) pool, the block
    table (pages scattered through the pool when ``shuffle``) and the
    lengths, all on ``device``."""
    B, S, H, KV, hd, psz, lens, _, _ = case
    q, k, v = _inputs(seed, [(B, H, hd), (B, S, KV, hd), (B, S, KV, hd)],
                      dtype, device)
    ns = S // psz
    P = B * ns
    kp = k.reshape(P, psz, KV, hd)
    vp = v.reshape(P, psz, KV, hd)
    tbl = torch.arange(P, dtype=torch.int32).reshape(B, ns)
    if shuffle:
        perm = torch.from_numpy(np.random.default_rng(seed).permutation(P))
        kp, vp = kp[perm.to(device)], vp[perm.to(device)]
        tbl = torch.argsort(perm).to(torch.int32).reshape(B, ns)
    lens = torch.tensor(lens, dtype=torch.int32)
    return q, kp, vp, lens.to(device), tbl.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAGED_CASES + PAGE_SIZE_CASES
                         + PAGED_TIMING_CASES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffled", "in-order"])
def test_paged_kernel_matches_plain(gpu, case, dtype, shuffle):
    window, cap = case[-2:]
    q, kp, vp, lens, tbl = paged_inputs(case, dtype, gpu, shuffle=shuffle)
    before = paged_kernel.LAUNCHES
    out = dec_ops.paged_decode_attention(q, kp, vp, lens, tbl, window=window,
                                         logit_cap=cap)
    ref = paged_decode_attention_ref(q, kp, vp, lens, tbl, window=window,
                                     logit_cap=cap)
    torch.cuda.synchronize()
    assert paged_kernel.LAUNCHES == before + 1
    tol = DTYPES[dtype][1]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    empty = lens == 0
    assert (out[empty] == 0).all()                 # freed slots: exact zeros


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [32, 64, 128, 256])
def test_paged_kernel_matches_plain_at_the_tuned_class(gpu, page_size):
    """The inputs the autotuner times K3 on for SmolLM-360M's batch-8
    decode class (BKV 64, G 3, hd 64, S 1024), in bfloat16."""
    cls = autotune.shape_class("paged_decode_attention", BKV=40, G=3, hd=64,
                               S=544)
    q, kp, vp, lens, tbl = autotune.paged_inputs(cls, torch.bfloat16,
                                                 page_size, gpu)
    out = dec_ops.paged_decode_attention(q, kp, vp, lens, tbl)
    ref = paged_decode_attention_ref(q, kp, vp, lens, tbl)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_paged_kernel_never_reads_past_a_slot(gpu):
    """The reference's garbage test: pages past each slot's length hold
    1e4 and their table entries point far outside the pool.  The kernel
    must neither read them (an illegal address would fault at the
    synchronise) nor let them into the output."""
    case = (2, 256, 4, 2, 64, 64, (70, 128), None, None)
    q, kp, vp, lens, tbl = paged_inputs(case, "float32", gpu, shuffle=False)
    ref = paged_decode_attention_ref(q, kp, vp, lens, tbl)
    used = (torch.arange(tbl.shape[1], device=gpu)[None, :]
            < ((lens + 63) // 64)[:, None])
    page_used = used.reshape(-1)
    kp = torch.where(page_used[:, None, None, None], kp, torch.full_like(kp, 1e4))
    vp = torch.where(page_used[:, None, None, None], vp, torch.full_like(vp, 1e4))
    tbl = torch.where(used, tbl, torch.full_like(tbl, 10_000))
    out = dec_ops.paged_decode_attention(q, kp, vp, lens, tbl)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_paged_kernel_attends_no_key_past_the_table(gpu):
    """A length beyond the table's ns pages attends the ns pages, as the
    plain version does, and reads no table entry past the row."""
    case = (2, 256, 4, 2, 64, 64, (256, 100), None, None)
    q, kp, vp, lens, tbl = paged_inputs(case, "float32", gpu)
    long = torch.tensor([300, 100], dtype=torch.int32, device=gpu)
    out = dec_ops.paged_decode_attention(q, kp, vp, long, tbl[:, :3])
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, paged_decode_attention_ref(q, kp, vp, long, tbl[:, :3]),
        atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_paged_unsupported_cuda_input_raises(gpu):
    case = (2, 256, 4, 2, 64, 64, (70, 128), None, None)
    q, kp, vp, lens, tbl = paged_inputs(case, "float32", gpu)
    with pytest.raises(ValueError, match="dtype"):
        dec_ops.paged_decode_attention(q.half(), kp.half(), vp.half(), lens,
                                       tbl)
    with pytest.raises(ValueError, match="head_dim"):
        dec_ops.paged_decode_attention(q[..., :20].contiguous(),
                                       kp[..., :20].contiguous(),
                                       vp[..., :20].contiguous(), lens, tbl)
    with pytest.raises(ValueError, match="devices"):
        dec_ops.paged_decode_attention(q, kp.cpu(), vp.cpu(), lens, tbl)
    with pytest.raises(ValueError, match="device"):
        dec_ops.paged_decode_attention(q.to("meta"), kp.to("meta"),
                                       vp.to("meta"), lens, tbl)


@pytest.mark.cuda
@pytest.mark.parametrize("split_len", [64, 128, 320, 1024])
def test_decode_kernel_takes_any_split_len(gpu, split_len):
    """K2's split_len knob, as the autotuner sets it: every split gives the
    plain version's output."""
    B, S, H, KV, hd, pos = 2, 1024, 8, 2, 64, 700
    q, k, v = _inputs(1, [(B, H, hd), (B, S, KV, hd), (B, S, KV, hd)],
                      "float32", gpu)
    out = dec_ops.decode_attention(q, k, v, pos, split_len=split_len)
    torch.testing.assert_close(out, decode_attention_ref(q, k, v, pos),
                               atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="split_len"):
        dec_ops.decode_attention(q, k, v, pos, split_len=100)


@pytest.mark.cuda
def test_tune_paged_times_every_page_size_through_the_kernel(gpu, tmp_path):
    prev = autotune._state["cache_dir"]     # restore, not pin, the location
    autotune.configure(cache_dir=str(tmp_path))
    try:
        before = paged_kernel.LAUNCHES
        dims = dict(BKV=8, G=3, hd=64, S=1024)
        e = autotune.tune("paged_decode_attention", "bfloat16", prune=False,
                          iters=3, **dims)
        torch.cuda.synchronize()
        sizes = sorted(json.loads(c)["page_size"] for c in e["candidates_timed"])
        assert sizes == [32, 64, 128, 256]
        assert paged_kernel.LAUNCHES - before == \
            4 * (1 + autotune.GRAPH_CALLS)
        assert e["backend"].startswith("torch-cuda:")
        gen = autotune.generation()
        again = autotune.tune("paged_decode_attention", "bfloat16", **dims)
        assert again["config"] == e["config"] and autotune.generation() == gen
        assert dec_ops.resolve_page_size(
            torch.bfloat16, B=8, H=3, KV=1, hd=64,
            seq_budget=1024) == e["config"]["page_size"]
    finally:
        autotune._state["cache_dir"] = prev
        autotune.configure(tune_on_miss=False)


@pytest.mark.cuda
def test_plain_flash_on_the_card_ignores_the_tuned_tile(gpu, tmp_path):
    """On the card the flash class's entry is the kernel's fixed tile; the
    plain blockwise flash, which the kernel is held against, keeps its
    default blocks whatever the cache holds."""
    prev = autotune._state["cache_dir"]
    autotune.configure(cache_dir=str(tmp_path))
    try:
        q, k, v = _inputs(2, [(2, 256, 6, 64), (2, 256, 2, 64),
                              (2, 256, 2, 64)], "float32", gpu)
        want = layers.flash_attention(q, k, v, causal=True,
                                      block_q=layers.DEFAULT_BLOCK_Q,
                                      block_k=layers.DEFAULT_BLOCK_K)
        autotune.tune("flash_attention", "float32", BKV=4, G=3, hd=64,
                      Tq=256, Tk=256, causal=True)
        assert autotune.lookup("flash_attention", torch.float32, device=gpu,
                               BKV=4, G=3, hd=64, Tq=256, Tk=256,
                               causal=True) is not None
        got = layers.flash_attention(q, k, v, causal=True)
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    finally:
        autotune._state["cache_dir"] = prev
        autotune.configure(tune_on_miss=False)


def _device_kernels(fn):
    """The names of the CUDA kernels ``fn`` runs on the card, by
    torch.profiler's trace."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [64, 128])
def test_decode_kernel_at_group_48(gpu, dtype, hd):
    """G 48 (an MQA model): the group is cut into six blocks of 8 rows."""
    B, S, H, KV, pos = 2, 1024, 48, 1, 700
    q, k, v = _inputs(9, [(B, H, hd), (B, S, KV, hd), (B, S, KV, hd)],
                      dtype, gpu)
    out = dec_ops.decode_attention(q, k * 4, v, pos, window=300)
    tol = DTYPES[dtype][1]
    torch.testing.assert_close(
        out.float(), decode_attention_ref(q, k * 4, v, pos,
                                          window=300).float(),
        atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,split_len", [(1024, 64), (2048, 64), (4096, 128)],
                         ids=["16 splits", "32 splits", "32 splits of 128"])
def test_decode_kernel_at_a_full_cluster_and_past_it(gpu, dtype, S,
                                                     split_len):
    """16 splits fill the largest cluster; more have each block walk
    several splits in turn."""
    B, H, KV, hd = 2, 8, 2, 64
    q, k, v = _inputs(10, [(B, H, hd), (B, S, KV, hd), (B, S, KV, hd)],
                      dtype, gpu)
    for pos in (S - 1, S // 3, 0):
        out = dec_ops.decode_attention(q, k * 4, v, pos, split_len=split_len)
        tol = DTYPES[dtype][1]
        torch.testing.assert_close(
            out.float(), decode_attention_ref(q, k * 4, v, pos).float(),
            atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("split_len", [None, 64])
def test_decode_is_one_launch_and_allocates_only_its_output(gpu, split_len):
    """One CUDA kernel per call, and the one allocation is the output: the
    splits merge in the cluster's shared memory, not in float32 scratch."""
    B, S, H, KV, hd = 8, 544, 15, 5, 64
    q, k, v = _inputs(11, [(B, H, hd), (B, KV, S, hd), (B, KV, S, hd)],
                      "bfloat16", gpu)
    pos = torch.tensor([S - 1], dtype=torch.int32, device=gpu)
    call = lambda: dec_ops.decode_attention_kvmajor(  # noqa: E731
        q, k, v, pos, split_len=split_len)
    call()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = call()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] - before == 1
    assert out.dtype == torch.bfloat16
    names = _device_kernels(call)
    assert len(names) == 1 and "decode_kernel" in names[0], names


@pytest.mark.cuda
def test_decode_launcher_constants_match_the_library(gpu):
    """``_lib`` holds the launcher's cluster, ring and group sizes against
    the built library's ``decode_attention_config``."""
    from repro_torch.kernels.decode_attention import decode_attention as k2
    k2._lib()


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [8, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_kernel_takes_x_as_a_strided_bf16_slice(gpu, offset, bc_dtype):
    """x as the model passes it: a bf16 slice of the convolution's output
    (B, T, H * P + 2 N), at an offset that keeps the 16-byte rule (the
    model's) and one that breaks it (read element by element)."""
    case = (2, 256, 8, 64, 64, 128)
    x, dt, A, Bm, Cm = ssd_inputs(case, bc_dtype, gpu, seed=3)
    B, T, H, P = x.shape
    wide = torch.zeros((B, T, H * P + 2 * 64 + 8), dtype=torch.bfloat16,
                       device=gpu)
    wide[..., offset:offset + H * P] = x.reshape(B, T, H * P)
    xs = wide[..., offset:offset + H * P].unflatten(-1, (H, P))
    y, state = ssd_ops.ssd_scan(xs, dt, A, Bm, Cm, chunk=128)
    y_ref, s_ref = ssd_chunked(xs.float(), dt, A, Bm, Cm, 128)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(state, s_ref, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_scan_launches_only_the_scan(gpu, x_dtype):
    """ops.ssd_scan forms xdt and dA inside the kernel: a call runs the
    scan's two kernels and no elementwise pass or copy."""
    from repro_torch.kernels.ssd_scan import ssd_scan as k4
    x, dt, A, Bm, Cm = ssd_inputs((8, 512, 64, 64, 128, 256),
                                  torch.bfloat16, gpu)
    x = x.to(x_dtype)
    call = lambda: ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=256)  # noqa
    call()
    names = _device_kernels(call)
    assert len(names) == k4.KERNELS_PER_CALL == 2, names
    assert all("ssd_" in n for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 300, 8, 64, 128, 300),
                                  (1, 700, 4, 32, 64, 350)], ids=str)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_kernel_at_ragged_chunks(gpu, case, x_dtype):
    """The chunks 300- and 700-token prompts give: not multiples of the
    kernel's 64-row tile, so the last tile of each chunk is ragged."""
    x, dt, A, Bm, Cm = ssd_inputs(case, torch.bfloat16, gpu, seed=4)
    x = x.to(x_dtype)
    y, state = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=case[-1])
    y_ref, s_ref = ssd_chunked(x.float(), dt, A, Bm, Cm, case[-1])
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(state, s_ref, atol=2e-3, rtol=2e-3)


# two slots of a 163,840-key context in 32-key pages: 5,120 table entries
# a slot, so the plan's splits of 256 pages (a block's table) number 20,
# past a cluster of 16
PAGED_LONG = (2, 163840, 8, 2, 64, 32, (163840, 70000), None, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [
    (2, 2048, 8, 2, 64, 32, (2048, 700), None, None), PAGED_LONG,
    PAGED_LONG[:7] + (300, None)],
    ids=["16 splits", "20 splits", "20 splits, window"])
def test_paged_kernel_at_a_full_cluster_and_past_it(gpu, dtype, case):
    """16 splits fill the largest cluster; a table longer than 16 splits of
    a block's 256 pages has each block walk several splits in turn,
    reading each split's table entries as it enters it."""
    B, S, H, KV, hd, psz = case[:6]
    _, n_split = paged_kernel.split_plan(B * KV, S // psz, psz)
    assert n_split == (16 if S == 2048 else 20)
    window = case[7]
    q, kp, vp, lens, tbl = paged_inputs(case, dtype, gpu)
    out = dec_ops.paged_decode_attention(q, kp * 4, vp, lens, tbl,
                                         window=window)
    ref = paged_decode_attention_ref(q, kp * 4, vp, lens, tbl, window=window)
    torch.cuda.synchronize()
    tol = DTYPES[dtype][1]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", [64, 128])
def test_paged_kernel_at_group_48(gpu, dtype, hd):
    """G 48 (an MQA model): the group is cut into six blocks of 8 rows."""
    case = (2, 1024, 48, 1, hd, 64, (1024, 333), 300, None)
    q, kp, vp, lens, tbl = paged_inputs(case, dtype, gpu)
    out = dec_ops.paged_decode_attention(q, kp * 4, vp, lens, tbl, window=300)
    ref = paged_decode_attention_ref(q, kp * 4, vp, lens, tbl, window=300)
    torch.cuda.synchronize()
    tol = DTYPES[dtype][1]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("broken", ["pointer", "strides"])
def test_paged_kernel_takes_a_pool_off_the_16_byte_rule(gpu, dtype, broken):
    """A pool view whose pointer sits 2 elements into rows of hd + 2, or
    whose rows are hd + 2 elements apart: no 16-byte copy can read it, so
    the kernel copies it element by element into its ring."""
    case = (3, 512, 6, 2, 64, 32, (512, 200, 0), None, 30.0)
    q, kp, vp, lens, tbl = paged_inputs(case, dtype, gpu)
    lo, hd = (2 if broken == "pointer" else 0), kp.shape[-1]
    views = []
    for x in (kp, vp):
        full = torch.zeros(*x.shape[:-1], hd + 2, dtype=x.dtype, device=gpu)
        full[..., lo:lo + hd] = x
        views.append(full[..., lo:lo + hd])
    before = paged_kernel.LAUNCHES
    out = dec_ops.paged_decode_attention(q, *views, lens, tbl, logit_cap=30.0)
    ref = paged_decode_attention_ref(q, kp, vp, lens, tbl, logit_cap=30.0)
    torch.cuda.synchronize()
    assert paged_kernel.LAUNCHES == before + 1
    tol = DTYPES[dtype][1]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    assert (out[lens == 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [PAGED_TIMING_CASES[0], PAGED_LONG],
                         ids=["5 splits", "20 splits walked"])
def test_paged_is_one_launch_and_allocates_only_its_output(gpu, case):
    """One CUDA kernel per call, and the one allocation is the output: the
    splits merge in the cluster's shared memory, not in float32 scratch,
    and the lengths and the table are read where they lie."""
    q, kp, vp, lens, tbl = paged_inputs(case, "bfloat16", gpu)
    call = lambda: dec_ops.paged_decode_attention(  # noqa: E731
        q, kp, vp, lens, tbl)
    call()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = call()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] - before == 1
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(
        out.float(), paged_decode_attention_ref(q, kp, vp, lens, tbl).float(),
        atol=2e-2, rtol=2e-2)
    names = _device_kernels(call)
    assert len(names) == 1 and "paged_kernel" in names[0], names


# The LM head (``models/head.py``): on the card its product takes bf16
# operands with float32 output (``mm.dtype``) and its backward a split
# float32 cotangent; on the CPU the same functions take the widened plain
# product.  Both sum exact float32 products, in orders of their own.
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma2_2b", "qwen3_moe_30b_a3b"])
def test_head_on_the_card_matches_the_widened_head(gpu, arch):
    """TINY ``arch`` in bf16 (Gemma-2: a tied head, softcap 30; Qwen3-MoE:
    untied): the served logits of 4 rows and the chunked cross-entropy of
    2 x 40 positions (chunks of 16), with the gradients of both with
    respect to the rows and the head, card against CPU on the same
    inputs.  The logits and the loss within 1e-5 of their largest, the
    gradients within one bf16 spacing of each one's largest (2^-8)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import head
    cfg = get_config(arch, tiny=True).replace(dtype="bfloat16")
    V, d = cfg.vocab_size, cfg.d_model
    name = "embed" if cfg.tie_embeddings else "lm_head"
    rng = np.random.default_rng(0)
    w = rng.standard_normal((V, d) if cfg.tie_embeddings else (d, V)) * 0.3
    h = rng.standard_normal((2, 40, d))
    labels = torch.from_numpy(rng.integers(0, V, (2, 40)))
    mask = torch.ones((2, 40))
    mask[:, -1] = 0.0
    ct = torch.from_numpy(rng.standard_normal((4, V)).astype(np.float32))
    got = {}
    for dev in (gpu, torch.device("cpu")):
        def leaf(x):
            return torch.from_numpy(x.astype(np.float32)).to(
                dev, torch.bfloat16).requires_grad_()
        tw, th, tr = leaf(w), leaf(h), leaf(h[:, 0, :].repeat(2, 0))
        logits = head.logits_last({name: tw}, tr, cfg)
        logits.backward(ct.to(dev))
        g_rows, g_head = tr.grad, tw.grad
        tw.grad = None
        loss = head.chunked_ce_loss({name: tw}, th, labels.to(dev),
                                    mask.to(dev), cfg, chunk=16)
        loss.backward()
        got[dev.type] = [t.detach().float().cpu() for t in (
            logits, g_rows, g_head, loss, th.grad, tw.grad)]
    for i, (a, b) in enumerate(zip(got["cuda"], got["cpu"])):
        rel = 1e-5 if i in (0, 3) else 2.0 ** -8
        assert (a - b).abs().max() <= rel * b.abs().max(), (
            i, (a - b).abs().max().item(), b.abs().max().item())
