"""The paged decode-attention kernel's (K3's) launch plan, on the CPU: the
split plan, the shared memory of every block the autotuner may launch, the
launcher's constants against the CUDA source, and the autotuner's roofline
model of the one-launch design.  The kernel itself runs only on the card
(test_torch_cuda_kernels.py)."""

import math
import re
from pathlib import Path

import pytest

from repro_torch.kernels.decode_attention import decode_attention as k2
from repro_torch.kernels.decode_attention import \
    paged_decode_attention as k3
from repro_torch.perf import autotune
from repro_torch.perf.roofline import F32_FLOPS, HBM_BPS, NUM_SMS

CSRC = Path(k3.__file__).resolve().parents[1] / "csrc"
PAGE_SIZES = (32, 64, 128, 256)            # the autotuner's candidates
# S the autotuner's shape classes bucket to, from a few pages to a long
# context; and the slots x kv heads of a batch, from one to past the card
TUNED_S = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 32768)
BKVS = (1, 2, 8, 16, 40, 64, 128, 264, 1024)


def _plans():
    for psz in PAGE_SIZES:
        for S in TUNED_S:
            if psz > S:
                continue
            for BKV in BKVS:
                yield BKV, S // psz, psz


@pytest.mark.parametrize("psz", PAGE_SIZES)
def test_split_plan_is_whole_pages_and_whole_tiles(psz):
    """Every split is whole pages and whole 64-key tiles, so whole tiles of
    the ring at any dtype and head size; the splits cover the table's keys
    with none empty; a split's pages fit the block's table."""
    ring_tiles = {k2.tile_keys(size, hd) for size in (2, 4)
                  for hd in (8, 16, 32, 64, 128, 256)}
    assert all(64 % kt == 0 for kt in ring_tiles)
    for BKV, ns, p in _plans():
        if p != psz:
            continue
        split_len, n_split = k3.split_plan(BKV, ns, psz)
        assert split_len % psz == 0 and split_len % 64 == 0, (BKV, ns)
        assert all(split_len % kt == 0 for kt in ring_tiles)
        assert split_len // psz <= k3.TABLE_PAGES
        assert (n_split - 1) * split_len < ns * psz <= n_split * split_len


def test_split_plan_caps_at_the_cluster_or_walks_past_it():
    """The plan never asks for more splits than a cluster holds, unless a
    split would hold more pages than the block's table: then the splits
    past the cluster are walked by its blocks in turn.  It depends on
    (BKV, ns, psz) only: the lengths stay on the device."""
    for BKV, ns, psz in _plans():
        split_len, n_split = k3.split_plan(BKV, ns, psz)
        assert n_split <= k3.MAX_CLUSTER \
            or split_len // psz == k3.TABLE_PAGES, (BKV, ns, psz)
        assert k3.blocks(BKV, 3, n_split) == BKV * min(n_split,
                                                       k3.MAX_CLUSTER)
    assert k3.split_plan(1, 1024, 32) == (2048, 16)
    # 8,192 pages of 32 keys for one slot: 32 splits of a full table
    assert k3.split_plan(1, 8192, 32) == (k3.TABLE_PAGES * 32, 32)
    assert k3.blocks(1, 3, 32) == k3.MAX_CLUSTER
    # SmolLM-360M's decode geometry: 5 splits of 128 keys, as K2's plan
    assert k3.split_plan(40, 17, 32) == (128, 5)
    assert k2.split_plan(40, 544) == (128, 5)


@pytest.mark.parametrize("size", [2, 4], ids=["bf16", "f32"])
def test_every_block_fits_the_shared_memory(size):
    """``smem_bytes`` of every head size and group the kernel takes fits a
    block's 227 KB, and so does every candidate the autotuner keeps."""
    for hd in (8, 16, 32, 64, 128, 256):
        for G in (1, 2, 3, 4, 5, 7, 8, 12, 16, 48):
            assert k3.smem_bytes(size, hd, G) <= 232_448, (hd, G)
    dtype = "bfloat16" if size == 2 else "float32"
    for hd, G in ((64, 3), (128, 8), (256, 4), (64, 48)):
        cls = autotune.shape_class("paged_decode_attention", BKV=64, G=G,
                                   hd=hd, S=1024)
        kept = autotune.prune_candidates("paged_decode_attention", cls,
                                         dtype, device="cpu")
        assert kept
        for cand in kept:
            _, smem = autotune._paged_model(cls, cand, size)
            assert smem == k3.smem_bytes(size, hd, G) <= 232_448


def test_paged_launcher_constants_match_the_cuda_source():
    """BK, the ring's depth, the cluster cap, the query rows a block holds
    and the table a block holds are the CUDA source's; the source launches
    one kernel per call and no merge kernel is left.  On the card ``_lib``
    holds them against the library too."""
    src = (CSRC / "paged_decode_attention.cu").read_text()
    common = (CSRC / "attn_common.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["MAX_CLUSTER"]) == k3.MAX_CLUSTER
    assert int(consts["NSTAGE"]) == k3.NSTAGE
    assert int(consts["GMAX"]) == k3.GMAX == k2.GMAX
    assert int(consts["TBL"]) == k3.TABLE_PAGES
    assert int(consts["NWARPS"]) == 4
    bk = dict(re.findall(r"constexpr int (\w+) = (\d+);", common))["BK"]
    assert int(bk) == k3._BK == 64
    assert "<<<" not in src and src.count("cudaLaunchKernelEx(") == 1
    for f in CSRC.iterdir():
        assert "merge_splits" not in f.read_text(), f.name


def test_paged_model_counts_no_partials():
    """The autotuner prices a candidate at one launch: the live pages, q and
    o, and the table, over the blocks of the cluster plan; no float32
    partial moves."""
    for BKV, G, hd, S in ((64, 3, 64, 1024), (8, 8, 128, 4096),
                          (2, 1, 64, 256)):
        cls = autotune.shape_class("paged_decode_attention", BKV=BKV, G=G,
                                   hd=hd, S=S)
        for cand in autotune._paged_candidates(cls, True):
            psz = cand["page_size"]
            ns = S // psz
            _, n_split = k3.split_plan(BKV, ns, psz)
            for size in (2, 4):
                nbytes = BKV * (size * (2 * ns * psz * hd + 2 * G * hd)
                                + 4 * ns)
                flops = 4.0 * BKV * G * ns * psz * hd
                fill = min(k3.blocks(BKV, G, n_split) / NUM_SMS, 1.0)
                want = max(flops / F32_FLOPS, nbytes / HBM_BPS) / fill
                got, _ = autotune._paged_model(cls, cand, size)
                assert math.isclose(got, want, rel_tol=1e-12), (cls, cand)
