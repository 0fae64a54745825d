"""Port decode-attention kernel: plain version and wrappers against the JAX
package (the jnp oracle, and the Pallas kernel in interpret mode), at the
reference's tolerances: 2e-5 in float32, 2e-2 in bfloat16.  The CUDA
kernel's own test is in test_torch_cuda_kernels.py."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.ops import \
    decode_attention as jax_pallas_decode  # noqa: E402
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as _jax_decode_ref  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402

# copies of the reference's case lists (tests/test_kernels.py,
# tests/test_paged_attention.py)
DECODE_CASES = [
    # (B, S, H, KV, hd, pos, window, cap)
    (2, 512, 8, 2, 64, 300, None, None),
    (1, 512, 4, 1, 128, 511, 128, None),
    (3, 300, 6, 6, 32, 150, None, 50.0),
    (2, 1024, 48, 1, 64, 700, None, None),        # granite-like MQA
    (1, 256, 32, 4, 128, 0, None, None),          # first token
]
KVMAJOR_CASES = [
    (2, 300, 8, 2, 64, 299, None, None),      # odd S
    (3, 300, 6, 3, 64, 150, None, None),      # non-pow2 heads
    (1, 512, 4, 1, 128, 37, None, None),      # single slot, short kv_len
    (1, 640, 12, 3, 64, 633, 128, None),      # single slot + window
    (2, 384, 10, 5, 32, 65, None, 40.0),      # non-pow2 heads + cap
    (1, 256, 8, 2, 64, 0, None, None),        # single slot, first token
]
jax_decode_ref = jax.jit(_jax_decode_ref,
                         static_argnames=("window", "logit_cap"))
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


@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_decode_matches_reference(case, dtype):
    B, S, H, KV, hd, pos, window, cap = case
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        1, [(B, H, hd), (B, S, KV, hd), (B, S, KV, hd)], dtype)
    kw = dict(window=window, logit_cap=cap)
    _close(decode_attention_ref(qt, kt, vt, pos, **kw),
           jax_decode_ref(qj, kj, vj, jnp.asarray(pos, jnp.int32), **kw),
           DTYPES[dtype][2])


@pytest.mark.parametrize("case", KVMAJOR_CASES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kvmajor_wrapper_matches_reference(case, dtype):
    """The model's (B, KV, S, hd) entry point; pos as a tensor, as the
    model passes it."""
    B, S, H, KV, hd, pos, window, cap = case
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        2, [(B, H, hd), (B, S, KV, hd), (B, S, KV, hd)], dtype)
    out = dec_ops.decode_attention_kvmajor(
        qt, kt.transpose(1, 2).contiguous(), vt.transpose(1, 2).contiguous(),
        torch.tensor(pos, dtype=torch.int32), window=window, logit_cap=cap)
    _close(out, jax_decode_ref(qj, kj, vj, jnp.asarray(pos, jnp.int32),
                               window=window, logit_cap=cap),
           DTYPES[dtype][2])


def test_decode_wrapper_matches_pallas_interpret():
    """SmolLM's decode heads against the Pallas kernel itself (interpret
    mode on the CPU), float32."""
    B, S, H, KV, hd, pos = 3, 544, 15, 5, 64, 530
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        4, [(B, H, hd), (B, S, KV, hd), (B, S, KV, hd)], "float32")
    _close(dec_ops.decode_attention(qt, kt, vt, pos),
           jax_pallas_decode(qj, kj, vj, jnp.asarray(pos, jnp.int32)), 2e-5)


def _source(name):
    from pathlib import Path
    return (Path(dec_ops.__file__).resolve().parents[1] / "csrc"
            / name).read_text()


def test_decode_launcher_constants_match_the_cuda_source():
    """The cluster, ring and group sizes the launcher and the autotuner
    price blocks by without a built library are the CUDA source's, and
    the group sizes it rounds up to are the ones ``by_group`` launches.
    On the card ``_lib`` holds them against the library too."""
    import re

    from repro_torch.kernels.decode_attention import decode_attention as k2
    src = _source("decode_attention.cu")
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["MAX_CLUSTER"]) == k2.MAX_CLUSTER == 16
    assert int(consts["NSTAGE"]) == k2.NSTAGE
    assert int(consts["GMAX"]) == k2.GMAX
    rows = {int(g) for g in re.findall(r"if \(need <= (\d+)\) DECODE_GB", src)}
    assert rows | {k2.GMAX} == {k2.group_rows(G) for G in range(1, 65)}
    lanes = [int(n) for n in re.findall(r"DECODE_LAUNCH\((\d+), \d\);", src)]
    assert lanes == [4, 8, 16, 32, 32]
    assert [k2.tile_keys(2, hd) for hd in (8, 64, 128, 256)] == [64, 64, 32, 16]
    assert [k2.tile_keys(4, hd) for hd in (8, 64, 128, 256)] == [64, 32, 16, 8]


@pytest.mark.parametrize("BKV", [1, 8, 40, 64, 512])
@pytest.mark.parametrize("S", [1, 64, 300, 544, 1024, 4096, 32768])
def test_split_plan_never_exceeds_a_cluster(BKV, S):
    """The default plan's splits are whole 64-key tiles, cover S, and never
    number more than one cluster holds."""
    from repro_torch.kernels.decode_attention import decode_attention as k2
    split_len, n_split = k2.split_plan(BKV, S)
    assert split_len % 64 == 0 and n_split == -(-S // split_len)
    assert 1 <= n_split <= k2.MAX_CLUSTER
    assert (n_split - 1) * split_len < S <= n_split * split_len


@pytest.mark.parametrize("split_len", [64, 128, 192, 320, 512, 1024, 2048])
def test_every_split_len_of_whole_tiles_is_accepted(split_len):
    """Any multiple of 64 passes the wrapper, however many splits it gives
    (the kernel's blocks walk the splits past a cluster in turn); a split
    that is not whole tiles raises."""
    B, S, H, KV, hd, pos = 2, 1024, 8, 2, 64, 700
    (_, qt), (_, kt), (_, vt) = _inputs(
        6, [(B, H, hd), (B, S, KV, hd), (B, S, KV, hd)], "float32")
    out = dec_ops.decode_attention(qt, kt, vt, pos, split_len=split_len)
    torch.testing.assert_close(out, decode_attention_ref(qt, kt, vt, pos),
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="split_len"):
        dec_ops.decode_attention(qt, kt, vt, pos, split_len=split_len + 32)
