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
    """What the kernels do not take raises on a tensor off the CPU (a meta
    tensor here: checked before any device is touched); a grouping no
    version can take raises on the CPU too.  On the CPU the kernels' own
    limits do not apply (test_torch_cpu_wrappers.py)."""
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
    if bad != "grouping":
        q, k, v = (x.to("meta") for x in (q, k, v))
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, k, v)
    kc, vc = k.transpose(1, 2), v.transpose(1, 2)
    with pytest.raises(ValueError):
        dec_ops.decode_attention_kvmajor(q[:, 0].contiguous(), kc, vc, 3)


# (block_q, block_k) the wrapper takes at G 3 and head_dim 64: the wgmma
# body's tiles, the other bodies' one tile (21 x 64), either side left to
# the cache or the default; and tiles no body has.  (block_q, block_k,
# head_dim) at head_dim 256, where the wgmma body has 64-key tiles only
TILES_TAKEN = [(64, 64), (64, 128), (128, 64), (128, 128), (21, 64),
               (21, None), (None, 128), (None, None), (128, 64, 256),
               (None, 64, 256), (21, 64, 256)]
TILES_REFUSED = [(32, 64), (64, 32), (256, 128), (96, None), (None, 21),
                 (21, 128), (128, 96), (64, 128, 256), (None, 128, 256),
                 (128, 128, 256)]


@pytest.mark.parametrize("tile", TILES_TAKEN + TILES_REFUSED, ids=str)
def test_flash_wrapper_validates_the_tile(tile):
    """Off the CPU a tile the kernel has at the call's head_dim is taken and
    any other raises before anything runs (a meta tensor, which then finds
    no kernel); on the CPU the plain version runs whatever the tile, as the
    reference's wrapper takes any tile."""
    hd = tile[2] if len(tile) > 2 else 64
    (_, qt), (_, kt), (_, vt) = _inputs(
        6, [(1, 40, 6, hd), (1, 40, 2, hd), (1, 40, 2, hd)], "bfloat16")
    out = flash_ops.flash_attention(qt, kt, vt, block_q=tile[0],
                                    block_k=tile[1])
    assert torch.equal(out, attention_ref(qt, kt, vt))
    qm, km, vm = (x.to("meta") for x in (qt, kt, vt))
    match = "tile" if tile in TILES_REFUSED else "no kernel for device meta"
    with pytest.raises(ValueError, match=match):
        flash_ops.flash_attention(qm, km, vm, block_q=tile[0],
                                  block_k=tile[1])


def test_flash_launcher_constants_match_the_cuda_source():
    """The wgmma constants the autotuner prices tiles by without a built
    library (tiles by head_dim, default tile, stages) are the CUDA
    source's: its instance list, which ``dispatch_wgmma`` launches and
    ``flash_wgmma_config`` reports, has the 10 tiles at head_dim 64, 128
    and 256.  On the card ``_lib`` holds them against the library too."""
    import re
    from pathlib import Path

    from repro_torch.kernels.flash_attention import \
        flash_attention as flash_kernel
    src = (Path(flash_kernel.__file__).resolve().parents[1] / "csrc"
           / "flash_attention.cu").read_text()
    body = src[src.index("#define FLASH_WGMMA_INSTANCES(X)"):]
    body = body[:body.index("\n\n")]
    rows = [tuple(map(int, m)) for m in
            re.findall(r"X\((\d+), (\d+), (\d+)\)", body)]
    bm, bn = re.search(r"WG_BM = (\d+), WG_BN = (\d+);", src).groups()
    stages = re.search(r"WG_STAGES = (\d+);", src).group(1)
    assert len(rows) == 10
    assert rows == [(hd, bq, bk) for hd, tiles in flash_kernel.TILES.items()
                    for bq, bk in tiles]
    assert {hd: [r[1:] for r in rows if r[0] == hd] for hd in (64, 128)} \
        == {hd: [(bq, bk) for bq in (64, 128) for bk in (64, 128)]
            for hd in (64, 128)}
    assert [r[1:] for r in rows if r[0] == 256] == [(64, 64), (128, 64)]
    assert (int(bm), int(bn)) == flash_kernel.DEFAULT_TILE
    assert all(flash_kernel.DEFAULT_TILE in t
               for t in flash_kernel.TILES.values())
    assert int(stages) == flash_kernel.STAGES
    assert flash_kernel.wgmma_smem(64, 64, 64) == 1024 + 2 * 64 * (
        64 + 2 * 2 * 64) + 8 * 5
    # head_dim 256: the two tiles fit a block's 232,448 bytes, a 128-key
    # tile does not
    assert [flash_kernel.wgmma_smem(256, bq, bk)
            for bq, bk in ((64, 64), (128, 64), (64, 128))] == \
        [164_904, 197_672, 295_976]
    assert all(flash_kernel.wgmma_smem(hd, bq, bk) <= 232_448
               for hd, tiles in flash_kernel.TILES.items()
               for bq, bk in tiles)


# head_dim 256 at Gemma-2-2B's group (G 2) and cap (50), apart from the
# reference's list above: (B, Tq, Tk, H, KV, hd, causal, window, cap,
# q_offset).  A window of 32 that cuts the 64-key tiles; Tq not a multiple
# of 64; q_offset with Tk > Tq under a window of 128
FLASH_256_CASES = [
    (1, 192, 192, 4, 2, 256, True, 32, 50.0, 0),
    (2, 100, 100, 4, 2, 256, True, None, 50.0, 0),
    (1, 70, 200, 4, 2, 256, True, 128, 50.0, 130),
]


@pytest.mark.parametrize("case", FLASH_256_CASES, ids=str)
def test_plain_flash_at_head_dim_256_matches_pallas_interpret(case):
    """The port's K1 on CPU tensors (its plain version) against the Pallas
    kernel in interpret mode, float32."""
    B, Tq, Tk, H, KV, hd, causal, window, cap, q_offset = case
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        7, [(B, Tq, H, hd), (B, Tk, KV, hd), (B, Tk, KV, hd)], "float32")
    kw = dict(causal=causal, window=window, logit_cap=cap, q_offset=q_offset)
    _close(flash_ops.flash_attention(qt, kt, vt, **kw),
           jax_pallas_flash(qj, kj, vj, **kw), 2e-5)


@pytest.mark.parametrize("case", FLASH_256_CASES, ids=str)
def test_plain_flash_at_head_dim_256_matches_reference_bf16(case):
    """The same cases in bfloat16 against the reference's ``attention_ref``
    at its bf16 tolerance."""
    B, Tq, Tk, H, KV, hd, causal, window, cap, q_offset = case
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        8, [(B, Tq, H, hd), (B, Tk, KV, hd), (B, Tk, KV, hd)], "bfloat16")
    kw = dict(causal=causal, window=window, logit_cap=cap, q_offset=q_offset)
    _close(flash_ops.flash_attention(qt, kt, vt, **kw),
           _jax_attention_ref(qj, kj, vj, **kw), 2e-2)
