"""The port's RealExecutor: the reference's executor tests
(``tests/test_autotune.py``'s RealExecutor AOT section) on the CPU, the
bookkeeping of one CUDA graph per batch bucket through a fake capturer
(``FakeGraphs``, injected in place of ``CudaGraphs``), ``generate``'s
device-side position counter, and, marked ``cuda``, the graphs on the
card against the eager path on TINY models.

This file imports no JAX, so the ``cuda`` tests run on a machine that has
only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_executor_aot.py
"""

import gc
import weakref

import pytest
import torch

from repro_torch.configs.base import InputShape, get_config
from repro_torch.core.controller import StaticController
from repro_torch.kernels.flash_attention import flash_attention as k1
from repro_torch.kernels.ssd_scan import ssd_scan as k4
from repro_torch.launch.serve import real_executor_for
from repro_torch.models import api
from repro_torch.serving import executor as executor_mod
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.executor import RealExecutor

TINY_ARCHS = ("smollm_360m", "mamba2_1p3b", "zamba2_1p2b", "internvl2_2b",
              "whisper_medium", "qwen3_moe_30b_a3b", "mixtral_8x22b")


class FakeGraph:
    """A 'graph' whose replay runs the captured callable eagerly."""

    def __init__(self, run, fail_replay=False):
        self.run = run
        self.fail_replay = fail_replay

    def replay(self):
        if self.fail_replay:
            raise RuntimeError("replay failed")
        self.run()


class FakeGraphs:
    """Stands in for ``executor.CudaGraphs`` on the CPU.  ``on_capture``
    runs inside each capture (a tuning, the wrappers' launch counts)."""

    def __init__(self, on_capture=None, fail_capture=False,
                 fail_replay=False):
        self.on_capture = on_capture
        self.fail_capture = fail_capture
        self.fail_replay = fail_replay
        self.warm_ups = 0
        self.captures = 0

    def warm_up(self, run):
        self.warm_ups += 1
        run()

    def capture(self, run):
        if self.fail_capture:
            raise RuntimeError("capture failed")
        self.captures += 1
        if self.on_capture is not None:
            self.on_capture()
        return FakeGraph(run, self.fail_replay), run()


@pytest.fixture
def fake_graphs(monkeypatch):
    fake = FakeGraphs()
    monkeypatch.setattr(executor_mod, "graph_capturer", lambda device: fake)
    return fake


def _randn(seed, *shape):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def _tiny_executor(calls=None, **kw):
    w = _randn(0, 16, 16)

    def fn(params, batch):
        if calls is not None:
            calls.append(batch["x"].shape[0])
        return torch.tanh(batch["x"] @ params).sum()

    def make_batch(n):
        return {"x": torch.ones((n, 16))}

    return RealExecutor(fn, w, make_batch, **kw)


# how the executor runs a bucket on the CPU: eagerly with aot off, eagerly
# with aot on (no graph exists on the CPU), or through the fake capturer
MODES = ("eager", "aot_on_the_cpu", "graphs")


@pytest.fixture(params=MODES)
def make_executor(request, monkeypatch):
    mode = request.param
    if mode == "graphs":
        monkeypatch.setattr(executor_mod, "graph_capturer",
                            lambda device: FakeGraphs())

    def make(**kw):
        ex = _tiny_executor(aot=mode != "eager", **kw)
        assert (ex._graphs is not None) == (mode == "graphs")
        return ex

    return make


# ---------------------------------------------------------------------------
# The reference's executor tests, on the port's RealExecutor.
# ---------------------------------------------------------------------------
def test_zero_recompiles_after_warmup(make_executor):
    ex = make_executor()
    probe_points = [(1, 1), (2, 1), (3, 1), (4, 2), (16, 1), (5, 3), (32, 1)]
    for bs, mtl in probe_points:              # warmup: captures happen here
        ex.run_step(bs, mtl)
    assert ex.cache_stats.misses > 0
    ex.cache_stats.reset_counters()
    for bs, mtl in probe_points * 3:          # steady state: all cache hits
        res = ex.run_step(bs, mtl)
        assert res["compile_time"] == 0.0
    assert ex.cache_stats.misses == 0
    assert ex.cache_stats.hits == len(probe_points) * 3


def test_bucketing_shares_executables(make_executor):
    ex = make_executor()
    ex.run_step(5, 1)                         # bucket 8
    ex.run_step(7, 1)                         # same bucket -> no capture
    ex.run_step(2, 4)                         # bs*mtl = 8 -> same bucket
    assert ex.cache_stats.misses == 1
    assert ex.cache_stats.hits == 2


def test_compile_time_charged_to_engine_clock(make_executor):
    ex = make_executor()
    eng = ServingEngine(ex, slo_s=1.0)
    acc = eng.run(StaticController(bs=4, mtl=1), max_steps=5)
    assert acc.compile_stall_s > 0.0          # first step warmed up
    assert acc.total_time >= acc.compile_stall_s
    assert acc.summary()["compile_stall_s"] == acc.compile_stall_s


def test_donate_batch_path_runs(make_executor):
    ex = make_executor(donate_batch=True)
    r1 = ex.run_step(4, 1)
    r2 = ex.run_step(4, 1)
    assert r1["items"] == r2["items"] == 4
    assert r2["compile_time"] == 0.0


def test_fits_memory_aware(make_executor):
    ex = make_executor()
    assert ex.fits(64, 64) and not ex.fits(4097, 1)     # legacy default
    exm = make_executor(mem_bytes=1e6, act_bytes_per_item=1e4)
    assert exm.fits(1, 1)
    assert not exm.fits(50, 4)                # 200 items * 1e4 B > 1 MB
    # budget big enough for everything the legacy rule rejected
    exl = make_executor(mem_bytes=1e12, act_bytes_per_item=1.0)
    assert exl.fits(4097, 2)


@pytest.mark.parametrize("donate", [False, True])
def test_donated_steps_each_read_a_fresh_batch(make_executor, donate):
    """A run that consumes its input in place (what donation allows) sees
    the bucket's original batch on every step only with ``donate_batch``:
    it is staged again from a host copy before each step, into the graph's
    static input under a graph."""
    seen = []

    def fn(params, batch):
        seen.append(float(batch["x"][0, 0]))
        batch["x"].add_(1.0)
        return batch["x"].sum()

    ex = make_executor(donate_batch=donate)
    ex.fn = fn
    for _ in range(3):
        ex.run_step(2, 1)
    ex.mean_latency(2, 1, iters=2)
    served = seen[-5:]                        # the steps, then the probe
    if donate:
        fresh = ([1.0] * 3 + [1.0, 1.0] if ex._graphs is None
                 else [1.0] * 3 + [1.0, 2.0])  # one static input per probe
        assert served == fresh
    else:
        assert served == sorted(served) and len(set(served)) == 5


def test_the_cpu_runs_eagerly_whatever_aot_says():
    for aot in (True, False):
        calls = []
        ex = _tiny_executor(calls, aot=aot)
        assert ex._graphs is None and ex.aot is aot
        ex.run_step(3, 1)                     # warm-up run, then the step
        ex.run_step(4, 1)
        assert calls == [4, 4, 4]
        assert ex.captures == 0 and not ex.replayed_launches


# ---------------------------------------------------------------------------
# One graph per bucket: the bookkeeping, through the fake capturer.
# ---------------------------------------------------------------------------
def test_one_capture_per_bucket_and_every_step_replays(fake_graphs):
    calls = []
    ex = _tiny_executor(calls)
    points = [(1, 1), (3, 1), (4, 1), (5, 1), (2, 4), (16, 1)]
    for bs, mtl in points * 2:
        ex.run_step(bs, mtl)
    ex.mean_latency(3, 1, iters=3)
    buckets = {ex.bucket(bs * mtl) for bs, mtl in points}      # 1, 4, 8, 16
    assert fake_graphs.captures == fake_graphs.warm_ups == len(buckets)
    assert ex.captures == len(buckets) and ex.capture_time_s >= 0.0
    assert sorted(ex._exec) == sorted(buckets)
    replays = {n: e.replays for n, e in ex._exec.items()}
    assert replays == {1: 2, 4: 4 + 3, 8: 4, 16: 2}
    # a warm-up run and a captured run per bucket, then one run per replay
    assert len(calls) == 2 * len(buckets) + sum(replays.values())
    assert all(e.graph is not None for e in ex._exec.values())


def test_generation_is_read_after_the_capture(monkeypatch):
    """A tuning that lands during a bucket's capture is already in its
    graph: the entry carries the generation read after the capture and is
    served, not evicted, on the next step (as the reference reads it after
    compiling)."""
    gen = [0]
    fake = FakeGraphs(on_capture=lambda: gen.__setitem__(0, gen[0] + 1))
    monkeypatch.setattr(executor_mod, "graph_capturer", lambda device: fake)
    ex = _tiny_executor(tile_generation=lambda: gen[0])
    ex.run_step(4, 1)
    assert ex._exec[4].generation == 1
    ex.cache_stats.reset_counters()
    ex.run_step(4, 1)
    assert (ex.cache_stats.hits, ex.cache_stats.misses,
            ex.cache_stats.stale_evictions, ex.cache_stats.stale_hits) == \
        (1, 0, 0, 0)
    assert fake.captures == 1


def test_a_stale_graph_is_evicted_and_captured_again(fake_graphs):
    gen = [0]
    ex = _tiny_executor(tile_generation=lambda: gen[0])
    ex.run_step(4, 1)
    first = ex._exec[4].graph
    gen[0] = 1                                # a tuning between steps
    ex.cache_stats.reset_counters()
    res = ex.run_step(4, 1)
    assert res["compile_time"] > 0.0
    assert (ex.cache_stats.misses, ex.cache_stats.stale_evictions,
            ex.cache_stats.stale_hits) == (1, 1, 0)
    assert fake_graphs.captures == 2 and ex._exec[4].graph is not first
    assert ex._exec[4].generation == 1


def test_a_tuning_during_a_replay_counts_a_stale_hit(fake_graphs):
    gen = [0]
    ex = _tiny_executor(tile_generation=lambda: gen[0])
    ex.run_step(4, 1)
    ex._exec[4].graph.run = lambda: gen.__setitem__(0, 1)
    ex.cache_stats.reset_counters()
    ex.run_step(4, 1)                         # served, then found stale
    assert ex.cache_stats.stale_hits == 1 and 4 not in ex._exec
    ex.run_step(4, 1)
    assert ex.cache_stats.misses == 1 and fake_graphs.captures == 2


def test_shutdown_drops_the_graphs(fake_graphs):
    ex = _tiny_executor()
    ex.warmup(4, 1)
    ex.warmup(16, 1)
    refs = [weakref.ref(e.graph) for e in ex._exec.values()]
    assert ex.shutdown() >= 0.0
    gc.collect()
    assert not ex._exec and all(r() is None for r in refs)
    ex.cache_stats.reset_counters()
    ex.run_step(4, 1)                         # relaunched: captured again
    assert ex.cache_stats.misses == 1 and fake_graphs.captures == 3


@pytest.mark.parametrize("where", ["capture", "replay"])
def test_a_failed_capture_or_replay_raises(monkeypatch, where):
    """On the card a capture or replay that fails raises; the executor
    never gives way to an eager run."""
    fake = FakeGraphs(fail_capture=where == "capture",
                      fail_replay=where == "replay")
    monkeypatch.setattr(executor_mod, "graph_capturer", lambda device: fake)
    calls = []
    ex = _tiny_executor(calls)
    with pytest.raises(RuntimeError, match=f"{where} failed"):
        ex.run_step(4, 1)
    with pytest.raises(RuntimeError, match=f"{where} failed"):
        ex.mean_latency(4, 1)
    if where == "capture":
        assert not ex._exec and calls == [4, 4]          # the two warm-ups
    else:
        assert calls == [4, 4]      # warm-up and capture; no eager step


def test_replayed_launches_count_every_replay(monkeypatch):
    """The wrappers count a kernel where its launch is recorded, once per
    capture; the executor counts each replay's launches."""
    monkeypatch.setattr(k1, "LAUNCHES", k1.LAUNCHES)
    monkeypatch.setattr(k4, "LAUNCHES", k4.LAUNCHES)
    monkeypatch.setitem(k1.LAUNCHES_BY_BODY, "wgmma",
                        k1.LAUNCHES_BY_BODY["wgmma"])

    def captured_launches():                  # what a model's capture adds
        k1.LAUNCHES += 3
        k1.LAUNCHES_BY_BODY["wgmma"] += 3
        k4.LAUNCHES += 2

    fake = FakeGraphs(on_capture=captured_launches)
    monkeypatch.setattr(executor_mod, "graph_capturer", lambda device: fake)
    ex = _tiny_executor()
    before = (k1.LAUNCHES, k4.LAUNCHES)
    for _ in range(5):
        ex.run_step(4, 1)
    ex.mean_latency(4, 1, iters=3)
    assert ex._exec[4].launches == {"flash": 3, "flash/wgmma": 3,
                                    "ssd_scan": 2}
    assert ex._exec[4].replays == 8
    assert ex.replayed_launches == {"flash": 24, "flash/wgmma": 24,
                                    "ssd_scan": 16}
    assert (k1.LAUNCHES, k4.LAUNCHES) == (before[0] + 3, before[1] + 2)


# ---------------------------------------------------------------------------
# generate: the position counter is made on the device.
# ---------------------------------------------------------------------------
def _generate_with_a_host_position(params, batch, cfg, steps):
    """``generate`` as it was, its position copied from the host."""
    tokens = batch["tokens"]
    T = api.prefill_len(batch)
    logits, cache = api.prefill(params, batch, cfg, capacity=T + steps)
    tok = logits.argmax(-1).to(torch.int32)
    out = [tok]
    pos = torch.tensor(T, dtype=torch.int32, device=tokens.device)
    for _ in range(steps):
        logits, cache = api.decode_step(params, cache, tok, pos, cfg)
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok)
        pos = pos + 1
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("arch", TINY_ARCHS)
def test_generate_tokens_unchanged_by_the_device_position(arch):
    cfg = get_config(arch, tiny=True).replace(kernel_impl="pallas")
    params = api.init_params(cfg, seed=0, device="cpu")
    batch = api.make_batch(cfg, InputShape("t", 24, 3, "prefill"), seed=1,
                           device="cpu")
    got = api.generate(params, batch, cfg, 5)
    want = _generate_with_a_host_position(params, batch, cfg, 5)
    assert got.shape == (3, 6) and torch.equal(got, want)


@pytest.mark.parametrize("arch", TINY_ARCHS)
def test_generate_copies_nothing_from_the_host(arch, monkeypatch):
    """Nothing on the served path builds a tensor from host data, which a
    CUDA graph cannot capture."""
    cfg = get_config(arch, tiny=True).replace(kernel_impl="pallas")
    params = api.init_params(cfg, seed=0, device="cpu")
    batch = api.make_batch(cfg, InputShape("t", 24, 2, "prefill"), seed=1,
                           device="cpu")

    def no_host_data(*a, **kw):
        raise AssertionError("torch.tensor on the served path")

    monkeypatch.setattr(torch, "tensor", no_host_data)
    assert api.generate(params, batch, cfg, 3).shape == (2, 4)


@pytest.mark.parametrize("arch,leaf", [("internvl2_2b", "patch_embeds"),
                                       ("whisper_medium", "audio_embeds")])
@pytest.mark.parametrize("mode", ("eager", "graphs"))
def test_frontend_leaves_are_warmed_sized_and_staged(arch, leaf, mode,
                                                     monkeypatch):
    """``serve``'s executor for a model with a stubbed frontend: the
    per-item bytes count the frontend's embeddings, the bucket's warm-up
    (and capture) takes them, and with ``donate_batch`` every step reads a
    fresh copy of the host template, embeddings included."""
    fake = FakeGraphs()
    if mode == "graphs":
        monkeypatch.setattr(executor_mod, "graph_capturer",
                            lambda device: fake)
    ex, cfg = real_executor_for(arch, tiny=True, device="cpu", prompt_len=32,
                                new_tokens=2)
    one = ex.make_batch(1)
    assert set(one) == {"tokens", leaf}
    assert ex._batch_bytes_per_item() == executor_mod.ACT_MULT * sum(
        x.numel() * x.element_size() for x in one.values())
    seen = []
    fn = ex.fn
    ex.fn = lambda p, b: seen.append(b) or fn(p, b)
    ex.donate_batch = True
    ex.run_step(3, 1)
    entry = ex._exec[ex.bucket(3)]
    assert fake.captures == (mode == "graphs")
    assert entry.host[leaf].shape == (4, *one[leaf].shape[1:])
    entry.batch[leaf].zero_()           # a step must restore the template
    before = len(seen)
    ex.run_step(3, 1)
    assert len(seen) == before + 1
    staged = seen[-1]
    assert torch.equal(staged[leaf], entry.host[leaf])
    assert (staged is entry.batch) == (mode == "graphs")


# ---------------------------------------------------------------------------
# On the card: the graphs against the eager path (TINY models).
# ---------------------------------------------------------------------------
@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs need an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cuda_executor(arch):
    return real_executor_for(arch, tiny=True, device="cuda", prompt_len=64,
                             new_tokens=8)


def _replayed_equals_eager(ex, cfg, n) -> None:
    ex.run_step(n, 1)
    entry = ex._exec[ex.bucket(n)]
    assert entry.graph is not None and entry.out.shape == (n, 9)
    eager = api.generate(ex.params, entry.batch, cfg, 8)
    torch.cuda.synchronize()
    assert torch.equal(entry.out, eager), (cfg.name, n)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", TINY_ARCHS + ("gemma2_2b",))
def test_replayed_tokens_equal_eager(gpu, arch):
    """Gemma2 also takes ``embed_tokens``' product with a 0-d CPU tensor
    (a scalar to the kernel, no copy) into the graph."""
    ex, cfg = _cuda_executor(arch)
    ex.warmup(8, 1)
    assert ex.captures == 1 and ex._exec[8].launches
    _replayed_equals_eager(ex, cfg, 8)
    _replayed_equals_eager(ex, cfg, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ("smollm_360m", "mamba2_1p3b"))
def test_buckets_replay_in_any_order(gpu, arch):
    """Buckets captured 8 then 16 into one memory pool, replayed 16, 8,
    16: each still equals the eager path."""
    ex, cfg = _cuda_executor(arch)
    ex.warmup(8, 1)
    ex.warmup(16, 1)
    for n in (16, 8, 16):
        _replayed_equals_eager(ex, cfg, n)
    assert ex.cache_stats.misses == 2


@pytest.mark.cuda
def test_a_larger_capture_leaves_the_first_graph_correct(gpu):
    """A capture that needs more SSD-scan counters (16 sequences x the
    heads, not 1 x) frees nothing the first graph writes: memory freed
    after it and filled with garbage does not reach its replay."""
    ex, cfg = _cuda_executor("mamba2_1p3b")
    ex.warmup(1, 1)
    ex.warmup(16, 1)
    torch.cuda.empty_cache()
    junk = [torch.full((1 << 16,), 7, dtype=torch.int32, device=gpu)
            for _ in range(64)]
    _replayed_equals_eager(ex, cfg, 1)
    _replayed_equals_eager(ex, cfg, 16)
    del junk


@pytest.mark.cuda
def test_a_capture_that_copies_from_the_host_raises(gpu):
    def fn(params, batch):
        return batch["x"] * torch.tensor(2.0, device=batch["x"].device)

    ex = RealExecutor(fn, torch.ones(4, device=gpu),
                      lambda n: {"x": torch.ones((n, 4), device=gpu)})
    with pytest.raises(RuntimeError):
        ex.warmup(4, 1)
    assert not ex._exec and ex.captures == 0
    y = torch.ones(8, device=gpu) * 3       # the card still works
    torch.cuda.synchronize()
    assert float(y.sum()) == 24.0
