"""The port's autotuner on the CPU: the counterparts of the reference's
tests/test_autotune.py cache, pruning and wrapper tests, the memoised
lookup, the RealExecutor's generation key, and the coexistence of the
port's and the reference's entries in one profile store."""

import json

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.decode_attention import split_plan
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import layers
from repro_torch.perf import autotune, profile_store
from repro_torch.perf.roofline import SMEM_PER_BLOCK
from repro_torch.serving.executor import RealExecutor

CPU = torch.device("cpu")


@pytest.fixture
def tuner(tmp_path):
    """The autotuner on a fresh store; the prior location restored after
    (pinning the default would disable a REPRO_AUTOTUNE_CACHE override)."""
    prev = autotune._state["cache_dir"]
    autotune.configure(cache_dir=str(tmp_path), tune_on_miss=False,
                       enabled=True)
    autotune.reset_counters()
    yield autotune
    autotune._state["cache_dir"] = prev
    autotune.configure(tune_on_miss=False, enabled=True)
    autotune.reset_counters()


# small shape classes, so the searches stay fast on the CPU
SEEDED = [
    ("flash_attention", dict(G=2, hd=32, Tq=128, Tk=128, causal=True)),
    ("decode_attention", dict(G=2, hd=32, S=256)),
    ("paged_decode_attention", dict(G=2, hd=32, S=256)),
    ("ssd_scan", dict(P=32, N=32, T=128)),
]


def _randn(seed, *shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def test_cache_round_trip_times_nothing_the_second_time(tuner):
    kernel, dims = SEEDED[0]
    e1 = tuner.tune(kernel, "float32", device="cpu", iters=2, **dims)
    stats = tuner.cache_stats()
    assert stats["tunes"] == 1 and stats["timings"] > 0
    n_timed = stats["timings"]

    e2 = tuner.tune(kernel, "float32", device="cpu", iters=2, **dims)
    assert e2["config"] == e1["config"]
    assert tuner.cache_stats()["timings"] == n_timed

    # drop the in-memory mirror: the entry comes back from disk
    tuner.configure(cache_dir=tuner.cache_dir())
    e3 = tuner.tune(kernel, "float32", device="cpu", iters=2, **dims)
    assert e3["config"] == e1["config"]
    assert tuner.lookup(kernel, torch.float32, device=CPU, BKV=1,
                        **dims) == e1["config"]
    assert tuner.cache_stats()["timings"] == n_timed
    with open(tuner.cache_path()) as f:
        disk = json.load(f)
    assert disk["schema"] == profile_store.SCHEMA_VERSION
    assert list(disk["autotune"]) == [
        "flash_attention|torch-cpu|float32|BKV=1,G=2,Tk=128,Tq=128,"
        "causal=True,hd=32"]
    assert disk["generations"]["autotune"] == tuner.generation() == 1


@pytest.mark.parametrize("on_card", [False, True], ids=["cpu", "card"])
@pytest.mark.parametrize("kernel,dims", SEEDED, ids=[k for k, _ in SEEDED])
def test_pruning_always_keeps_the_default(kernel, dims, on_card):
    device = "cuda" if on_card else "cpu"
    cls = autotune.shape_class(kernel, **dims)
    cands = autotune._KERNELS[kernel][0](cls, on_card)
    default = autotune._default(kernel, cls, on_card)
    for dtype in ("float32", "bfloat16"):
        kept = autotune.prune_candidates(kernel, cls, dtype, ratio=1.0,
                                         device=device)
        assert kept and all(c in cands for c in kept)
        if default in cands:
            assert default in kept


def test_hopper_candidates_and_defaults():
    """Each kernel's knob is the one its Hopper kernel takes."""
    dec = autotune.shape_class("decode_attention", BKV=40, G=3, hd=64, S=544)
    assert dec == {"BKV": 64, "G": 3, "hd": 64, "S": 1024}
    assert autotune._default("decode_attention", dec, True) == \
        {"split_len": split_plan(64, 1024)[0]}
    assert [c["split_len"] for c in
            autotune._decode_candidates(dec, True)][:5] == \
        [64, 128, 256, 512, 1024]
    flash = autotune.shape_class("flash_attention", BKV=40, G=3, hd=64,
                                 Tq=512, Tk=512, causal=True)
    assert autotune._flash_candidates(flash, True) == \
        [{"block_q": 21, "block_k": 64}]   # float32: the CUDA-core body's tile
    assert autotune._flash_candidates(flash, True, "bfloat16") == [
        {"block_q": bq, "block_k": bk}
        for bq in (64, 128) for bk in (64, 128)]     # the wgmma body's tiles
    assert len(autotune._flash_candidates(flash, False)) == 16
    paged = autotune.shape_class("paged_decode_attention", BKV=8, G=4,
                                 hd=64, S=100)
    assert [c["page_size"] for c in
            autotune._paged_candidates(paged, True)] == [32, 64, 128]
    ssd = autotune.shape_class("ssd_scan", H=64, P=64, N=128, T=512)
    assert [c["chunk"] for c in autotune._ssd_candidates(ssd, True)] == \
        [32, 64, 128, 256]
    for kernel, cls in (("decode_attention", dec),
                        ("paged_decode_attention", paged),
                        ("ssd_scan", ssd)):
        for cand in autotune._KERNELS[kernel][0](cls, True):
            _, smem = autotune._KERNELS[kernel][1](cls, cand, 2)
            assert smem <= SMEM_PER_BLOCK == 232_448


# (dtype, hd): the flash classes whose on-card candidates are the wgmma
# body's tiles at that head_dim (four at 64 and 128, the two 64-key tiles
# at 256), and classes that reach a body with one tile
WGMMA_FLASH = [("bfloat16", 64), ("bfloat16", 128), ("bfloat16", 256)]
FIXED_FLASH = [("float32", 64), ("float32", 128), ("bfloat16", 32),
               ("bfloat16", 96)]
WGMMA_TILES = {64: [(bq, bk) for bq in (64, 128) for bk in (64, 128)],
               128: [(bq, bk) for bq in (64, 128) for bk in (64, 128)],
               256: [(64, 64), (128, 64)]}


@pytest.mark.parametrize("dtype,hd", WGMMA_FLASH + FIXED_FLASH, ids=str)
@pytest.mark.parametrize("G", [1, 3, 8])
def test_flash_card_candidates_and_their_shared_memory(dtype, hd, G):
    """On the card the bf16 classes at head_dim 64, 128 and 256 offer the
    wgmma body's tiles at that head_dim, priced at its shared memory (the
    Q tile and two K/V stages in bf16, 1 KB of alignment slack, five
    mbarriers), every one under a block's 227 KB, with the default (64 x
    64) among them and kept by pruning; every other class has the one tile
    of the body it reaches."""
    cls = autotune.shape_class("flash_attention", BKV=40, G=G, hd=hd,
                               Tq=512, Tk=512, causal=True)
    cands = autotune._flash_candidates(cls, True, dtype)
    default = autotune._default("flash_attention", cls, True, dtype)
    kept = autotune.prune_candidates("flash_attention", cls, dtype,
                                     device="cuda")
    if (dtype, hd) in WGMMA_FLASH:
        assert cands == [{"block_q": bq, "block_k": bk}
                         for bq, bk in WGMMA_TILES[hd]]
        assert default == {"block_q": 64, "block_k": 64}
        for cand in cands:
            _, smem = autotune._flash_model(cls, cand, 2, True)
            assert smem == 2 * hd * (cand["block_q"] + 4 * cand["block_k"]) \
                + 1024 + 40
            assert smem <= SMEM_PER_BLOCK == 232_448
    else:
        assert cands == [default] == [{"block_q": max(64 // G, 1),
                                       "block_k": 64}]
    assert default in kept and all(c in cands for c in kept)


def test_flash_wrapper_resolves_the_tile(tuner):
    """Explicit keywords win; a side left None comes from the autotune
    cache for the class, else from the body's default (None)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    q, k = _randn(0, 1, 128, 2, 32), _randn(1, 1, 128, 1, 32)
    assert flash_ops._resolve_tile(None, None, q, k, True) == (None, None)
    assert flash_ops._resolve_tile(64, 128, q, k, True) == (64, 128)
    kernel, dims = SEEDED[0]
    cfg = tuner.tune(kernel, "float32", device="cpu", iters=1, **dims)[
        "config"]
    assert flash_ops._resolve_tile(None, None, q, k, True) == \
        (cfg["block_q"], cfg["block_k"])
    assert flash_ops._resolve_tile(64, None, q, k, True) == \
        (64, cfg["block_k"])
    assert flash_ops._resolve_tile(None, None, q, k, False) == (None, None)


def test_empty_cache_gives_todays_defaults(tuner):
    q, k, v = _randn(0, 1, 128, 4, 32), _randn(1, 1, 128, 2, 32), \
        _randn(2, 1, 128, 2, 32)
    torch.testing.assert_close(
        layers.flash_attention(q, k, v),
        layers.flash_attention(q, k, v, block_q=256, block_k=512),
        atol=0, rtol=0)
    q1, kc, vc = _randn(3, 2, 4, 32), _randn(4, 2, 256, 2, 32), \
        _randn(5, 2, 256, 2, 32)
    assert dec_ops._resolve_split_len(None, q1, 4, 2, 256) is None
    torch.testing.assert_close(dec_ops.decode_attention(q1, kc, vc, 200),
                               dec_ops.decode_attention(q1, kc, vc, 200,
                                                        split_len=64),
                               atol=0, rtol=0)
    x = _randn(6, 1, 128, 2, 32) * 0.5
    dt = torch.nn.functional.softplus(_randn(7, 1, 128, 2))
    A = -torch.exp(_randn(8, 2) * 0.5)
    Bm, Cm = _randn(9, 1, 128, 16) * 0.5, _randn(10, 1, 128, 16) * 0.5
    for got, want in zip(ssd_ops.ssd_scan(x, dt, A, Bm, Cm),
                         ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=128)):
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert dec_ops.resolve_page_size(torch.float32, B=2, H=4, KV=2, hd=32,
                                     seq_budget=256, device="cpu") == 64
    stats = tuner.cache_stats()
    assert stats["misses"] >= 4 and stats["hits"] == 0
    assert stats["tunes"] == 0 and stats["generation"] == 0


def test_tuned_config_reaches_each_wrapper(tuner, monkeypatch):
    entries = {k: tuner.tune(k, "float32", device="cpu", iters=1, **d)
               for k, d in SEEDED}
    # decode: the tuned split_len is what the wrappers resolve
    q1 = _randn(3, 1, 2, 32)          # the seeded classes: BKV 1, G 2
    resolved = []
    real_resolve = dec_ops._resolve_split_len
    monkeypatch.setattr(dec_ops, "_resolve_split_len",
                        lambda *a: resolved.append(real_resolve(*a))
                        or resolved[-1])
    dec_ops.decode_attention(q1, _randn(4, 1, 256, 1, 32),
                             _randn(5, 1, 256, 1, 32), 100)
    dec_ops.decode_attention_kvmajor(q1, _randn(4, 1, 1, 256, 32),
                                     _randn(5, 1, 1, 256, 32), 100)
    want = entries["decode_attention"]["config"]["split_len"]
    assert resolved == [want, want]
    # paged: the tuned page size
    assert dec_ops.resolve_page_size(
        torch.float32, B=1, H=2, KV=1, hd=32, seq_budget=256,
        device="cpu") == entries["paged_decode_attention"]["config"][
            "page_size"]
    # ssd: the tuned chunk reaches the plain chunked scan
    chunks = []
    real_chunked = ssd_ops.ssd_chunked
    monkeypatch.setattr(ssd_ops, "ssd_chunked",
                        lambda *a: chunks.append(a[-1]) or real_chunked(*a))
    x = _randn(6, 1, 128, 1, 32)
    ssd_ops.ssd_scan(x, torch.ones(1, 128, 1), -torch.ones(1),
                     _randn(7, 1, 128, 32), _randn(8, 1, 128, 32))
    assert chunks == [entries["ssd_scan"]["config"]["chunk"]]
    # the plain blockwise flash: the tuned blocks, and the output of
    # passing them explicitly
    cfg = entries["flash_attention"]["config"]
    q, k, v = _randn(0, 1, 128, 2, 32), _randn(1, 1, 128, 1, 32), \
        _randn(2, 1, 128, 1, 32)
    hits = tuner.cache_stats()["hits"]
    out = layers.flash_attention(q, k, v)
    assert tuner.cache_stats()["hits"] == hits + 1
    torch.testing.assert_close(
        out, layers.flash_attention(q, k, v, block_q=cfg["block_q"],
                                    block_k=cfg["block_k"]), atol=0, rtol=0)
    # an explicit keyword wins
    dec_ops.decode_attention(q1, _randn(4, 1, 256, 1, 32),
                             _randn(5, 1, 256, 1, 32), 100, split_len=128)
    assert resolved[-1] == 128


def test_lookup_is_memoised_until_the_generation_changes(tuner,
                                                         monkeypatch):
    """A hit is one dict lookup: it reads neither the store, its location
    nor its generation; a tuning or ``configure`` clears the memo."""
    loads, stamps = [], []
    real_load = autotune._load
    monkeypatch.setattr(autotune, "_load",
                        lambda: loads.append(1) or real_load())
    for name in ("cache_dir", "generation", "resolve_device"):
        real = getattr(autotune, name)
        monkeypatch.setattr(autotune, name,
                            lambda *a, _f=real, **k: stamps.append(1)
                            or _f(*a, **k))
    dims = dict(BKV=4, G=2, hd=32, S=256)
    for _ in range(5):
        assert tuner.lookup("decode_attention", torch.float32, device=CPU,
                            **dims) is None
    assert len(loads) == 1
    n_stamps = len(stamps)
    for _ in range(5):
        tuner.lookup("decode_attention", torch.float32, device=CPU, **dims)
    assert len(stamps) == n_stamps and len(loads) == 1
    entry = tuner.tune("decode_attention", "float32", device="cpu", iters=1,
                       **dims)
    n = len(loads)
    for _ in range(5):
        assert tuner.lookup("decode_attention", torch.float32, device=CPU,
                            **dims) == entry["config"]
    assert len(loads) == n + 1
    assert tuner.cache_stats()["hits"] == 5
    tuner.configure(cache_dir=tuner.cache_dir())
    n = len(loads)
    assert tuner.lookup("decode_attention", torch.float32, device=CPU,
                        **dims) == entry["config"]
    assert len(loads) == n + 1


def _tiny_executor(**kw):
    w = _randn(0, 16, 16)

    def fn(params, batch):
        return torch.tanh(batch["x"] @ params).sum()

    def make_batch(n):
        return {"x": torch.ones((n, 16))}

    return RealExecutor(fn, w, make_batch, **kw)


def test_generation_bump_evicts_the_real_executor_bucket(tuner):
    """A real tuning moves ``generation()``, the default tile generation
    the port's RealExecutor keys its warmed buckets on."""
    assert tuner.generation() == 0
    ex = _tiny_executor()
    ex.run_step(2, 1)
    ex.cache_stats.reset_counters()
    ex.run_step(2, 1)
    assert (ex.cache_stats.hits, ex.cache_stats.misses) == (1, 0)
    tuner.tune("ssd_scan", "float32", device="cpu", iters=1, P=32, N=16,
               T=64)
    assert tuner.generation() == 1
    ex.cache_stats.reset_counters()
    res = ex.run_step(2, 1)                       # same point: warmed again
    assert res["compile_time"] > 0.0
    assert ex.cache_stats.stale_evictions == 1
    assert ex.cache_stats.misses == 1
    assert ex.cache_stats.stale_hits == 0
    ex.cache_stats.reset_counters()
    ex.run_step(2, 1)
    assert (ex.cache_stats.misses, ex.cache_stats.stale_hits) == (0, 0)


def test_tune_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        autotune.tune("ssd_scan", "float32", P=16, N=16, T=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        autotune.lookup("ssd_scan", "float32", P=16, N=16, T=64)


def test_entries_never_collide_with_the_reference(tmp_path):
    """Both packages default to one store document.  Each package's lookup
    returns only its own entry, with its own knob names."""
    pytest.importorskip("jax")
    from repro.perf import autotune as ref_at
    prev_ref = ref_at._state["cache_dir"]
    prev = autotune._state["cache_dir"]
    dims = dict(G=2, hd=32, S=128)
    try:
        ref_at.configure(cache_dir=str(tmp_path), tune_on_miss=False)
        autotune.configure(cache_dir=str(tmp_path), tune_on_miss=False)
        ref_entry = ref_at.tune("decode_attention", "float32", iters=1,
                                **dims)
        port_entry = autotune.tune("decode_attention", "float32",
                                   device="cpu", iters=1, **dims)
        ref_at.configure(cache_dir=str(tmp_path))    # re-read the merged disk
        assert set(ref_entry["config"]) == {"block_k"}
        assert set(port_entry["config"]) == {"split_len"}
        assert ref_at.lookup("decode_attention", "float32",
                             **dims) == ref_entry["config"]
        assert autotune.lookup("decode_attention", torch.float32,
                               device=CPU, **dims) == port_entry["config"]
        with open(autotune.cache_path()) as f:
            keys = sorted(json.load(f)["autotune"])
        assert [k.split("|")[1] for k in keys] == ["cpu", "torch-cpu"]
    finally:
        ref_at._state["cache_dir"] = prev_ref
        ref_at._state["legacy_checked"] = None
        ref_at.configure(tune_on_miss=False, enabled=True)
        autotune._state["cache_dir"] = prev
        autotune.configure(tune_on_miss=False, enabled=True)


def test_decode_model_counts_the_cache_once_and_one_launch():
    """The split-K decode model: the cache, q and o each moved once and no
    float32 partials (the splits merge in shared memory), the blocks of
    one launch, the kernel's own shared memory."""
    from repro_torch.kernels.decode_attention import decode_attention as k2
    from repro_torch.perf.roofline import F32_FLOPS, HBM_BPS
    cls = {"BKV": 64, "G": 3, "hd": 64, "S": 1024}
    t, smem = autotune._decode_model(cls, {"split_len": 128}, 2)
    nbytes = 64 * 2 * (2 * 1024 * 64 + 2 * 3 * 64)
    flops = 4.0 * 64 * 3 * 1024 * 64
    assert k2.blocks(64, 3, 8) == 64 * 8 >= 132        # fills the card
    assert t == pytest.approx(max(flops / F32_FLOPS, nbytes / HBM_BPS))
    assert smem == k2.smem_bytes(2, 64, 3) == \
        4 * 2 * 64 * 64 * 2 + 4 * (2 * 3 * 64 + 2 * 3)
    # more splits than a cluster holds add no blocks
    assert k2.blocks(64, 3, 64) == k2.blocks(64, 3, 16) == 64 * 16


def test_ssd_model_counts_bytes_and_products_by_unit():
    """The SSD-scan model at the Mamba2 class: the fused kernel's bytes
    (bf16 x, B and C; float32 dt, A, y and the final state), C Bᵀ once
    per chunk at the bf16 peak, the split-TF32 products at the TF32 peak,
    and the output kernel's grid for the fill."""
    from repro_torch.kernels.ssd_scan import ssd_scan as k4
    from repro_torch.perf.roofline import BF16_FLOPS, HBM_BPS, TF32_FLOPS
    nbytes, work = k4.work(1, 512, 64, 64, 128, 256, 2, 2)
    assert nbytes == (2 * 512 * 64 * 64 + 4 * 512 * 64 + 4 * 64
                      + 2 * 2 * 512 * 128 + 4 * 512 * 64 * 64
                      + 4 * 64 * 64 * 128)
    pairs = 2 * 256 * 257 // 2
    assert work == [(2 * pairs * 128, BF16_FLOPS),
                    (2 * 64 * (3 * pairs * 64 + 2 * 512 * 64 * 128
                               + 2 * 256 * 64 * 128), TF32_FLOPS)]
    t_ops = sum(f / p for f, p in work)
    cls = autotune.shape_class("ssd_scan", H=64, P=64, N=128, T=512)
    t, smem = autotune._ssd_model(cls, {"chunk": 256}, 2)
    blocks = 4 * (64 // k4.HEADS_PER_BLOCK) * 2      # t tiles x head groups x chunks
    assert t == pytest.approx(max(t_ops, nbytes / HBM_BPS)
                              / min(blocks / 132, 1.0))
    assert smem == k4.smem_bytes(2, 2, 64, 128, 256) <= SMEM_PER_BLOCK
    # float32 B and C: C Bᵀ as three TF32 products, the products against B
    # and C three too
    _, w32 = k4.work(1, 512, 64, 64, 128, 256, 4, 4)
    assert w32[0] == (3 * 2 * pairs * 128, TF32_FLOPS)
    assert w32[1][0] - work[1][0] == 2 * 64 * (512 + 256) * 64 * 128
    # the Mamba2 serving batch moves about 120 MB
    assert 120e6 < k4.work(8, 512, 64, 64, 128, 256, 2, 2)[0] < 121e6
