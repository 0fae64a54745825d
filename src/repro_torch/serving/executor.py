"""Executors: where (simulated or real) inference time comes from.

Counterpart of ``repro.serving.executor``.

SimExecutor — analytical device model (device_model.py) + latency noise;
  a verbatim copy of the reference's.

RealExecutor — actually runs a model callable on the device and measures
  wall clock.  Multi-tenancy is emulated by folding MTL independent
  instance batches into one batch, as in the reference.

  Batch shapes are bucketed so scaler probes of nearby (bs, mtl) points
  reuse one bucket, and every bucket's first run is timed and reported in
  ``result["compile_time"]``, so the engine charges it to the service
  clock like an instance-launch stall.  The reference compiles one
  ahead-of-time executable per bucket (``aot=True``); the card's
  counterpart is one CUDA graph per bucket (``CudaGraphs``): a miss runs
  the bucket once eagerly on the capture stream (kernel builds, autotune
  searches), captures one run in a ``torch.cuda.CUDAGraph``, and every
  later probe and served step replays it, so the latencies the scalers
  read carry no per-op host dispatch.  A capture or replay that fails
  raises; nothing falls back to eager.  On the CPU no graph exists and
  the executor runs eagerly whatever ``aot`` says, as it does with
  ``aot=False`` on the card (the reference's jit without AOT): a
  bucket's warm-up is then one full run, ended by a synchronise.

  Cache hit/miss counters live in ``metrics.ExecCacheStats``;
  steady-state probing must show zero misses after warm-up.  A bucket
  carries the autotune generation (``perf.autotune.generation``) read
  after its warm-up and capture: a new tuning evicts it and captures it
  again, and serving a stale bucket counts as a ``stale_hit``.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.perf import autotune
from repro_torch.serving import device_model as dm
from repro_torch.serving import tenancy
from repro_torch.serving.metrics import ExecCacheStats


class SimExecutor:
    """Closed-loop simulated executor for one job."""

    def __init__(self, profile: dm.JobProfile, device: dm.Device = dm.TESLA_P40,
                 seed: int = 0, mesh_shape: Optional[tuple] = None,
                 partition=None, power_share: float = 1.0):
        self.profile = profile
        self.device = device
        self.sampler = dm.LatencySampler(seed=seed)
        self.mesh_shape = mesh_shape   # TPU mode: tenancy = submesh split
        self.partition = partition     # TenantSlice: spatial slice pricing
        self.power_share = power_share  # time-share fraction for power pricing
        self.clock = 0.0
        self._lat_cache: dict = {}     # (bs, mtl) -> mean latency (exact)
        self._power_cache: dict = {}   # (bs, mtl) -> (total_w, dynamic_w)
        self._tok_cache: dict = {}     # (slots, mtl, prefills) -> mean step

    def set_partition(self, ts) -> None:
        """Resize this executor's spatial slice (MPS set-percentage / MIG
        reconfigure): repricing only, no instance relaunch — the cheapness
        the cluster's resize-instead-of-migrate path exploits."""
        self.partition = ts
        self._lat_cache.clear()
        self._power_cache.clear()
        self._tok_cache.clear()

    # -- pricing ------------------------------------------------------------
    def mean_latency(self, bs: int, mtl: int) -> float:
        key = (bs, mtl)
        lat = self._lat_cache.get(key)
        if lat is None:
            lat = self._price(bs, mtl)
            self._lat_cache[key] = lat
        return lat

    def _price(self, bs: int, mtl: int) -> float:
        if self.partition is not None:
            ts = self.partition
            return dm.part_latency(self.device, self.profile, bs, mtl,
                                   inv_share=ts.inv_share,
                                   tenants=ts.tenants,
                                   isolation=ts.isolation)
        if self.mesh_shape is not None:
            # non-divisor MTLs over-partition (plan_at_least) instead of
            # returning inf — an inf step would poison the engine clock
            # and every downstream metric the moment a scaler probes one
            p = tenancy.plan_at_least(self.mesh_shape, mtl)
            if p is None:
                return float("inf")
            return dm.step_latency(self.device, self.profile, bs,
                                   share=p.share)["t_step"]
        return dm.mt_latency(self.device, self.profile, bs, mtl)

    def price_surface(self, bs_values, mtl_values) -> np.ndarray:
        """Mean-latency surface over the whole (bs, mtl) grid — one
        vectorized call per tenancy plan instead of a Python double loop.
        Shape (len(bs_values), len(mtl_values))."""
        bs_values = np.asarray(bs_values)
        if self.partition is not None:
            ts = self.partition
            return dm.part_latency_grid(self.device, self.profile,
                                        bs_values, mtl_values,
                                        inv_share=ts.inv_share,
                                        tenants=ts.tenants,
                                        isolation=ts.isolation)
        if self.mesh_shape is None:
            return dm.mt_latency_grid(self.device, self.profile,
                                      bs_values, mtl_values)
        cols = []
        for m in mtl_values:
            p = tenancy.plan_at_least(self.mesh_shape, int(m))
            if p is None:
                cols.append(np.full(len(bs_values), np.inf))
            else:
                cols.append(dm.step_latency_grid(
                    self.device, self.profile, bs_values,
                    share=p.share)["t_step"])
        return np.stack(cols, axis=1)

    def fits(self, bs: int, mtl: int) -> bool:
        dev = self.device
        if self.partition is not None:
            # the tenant sees only its memory slice, not the whole HBM
            import dataclasses
            dev = dataclasses.replace(
                dev, hbm_bytes=dev.hbm_bytes * self.partition.mem_fraction)
        return dm.fits_memory(dev, self.profile, bs, mtl)

    def power_terms(self, bs: int, mtl: int) -> tuple:
        """(total_w, dynamic_w) this executor's slice draws at (bs, mtl).

        Per-slice pricing (device_model.slice_power): a partitioned tenant
        draws its share of the idle floor plus share-scaled dynamic power on
        the partition latency law; a time-share tenant draws power_share of
        both.  dynamic_w = total_w - share * idle_w lets the cluster charge
        the idle floor ONCE per powered device instead of once per tenant.
        """
        key = (bs, mtl)
        terms = self._power_cache.get(key)
        if terms is None:
            ts = self.partition
            if ts is not None:
                share = ts.share
                total = dm.slice_power(self.device, self.profile, bs, mtl,
                                       share=share, inv_share=ts.inv_share,
                                       tenants=ts.tenants,
                                       isolation=ts.isolation)
            else:
                share = self.power_share
                total = dm.slice_power(self.device, self.profile, bs, mtl,
                                       share=share)
            terms = (total, total - share * self.device.idle_w)
            self._power_cache[key] = terms
        return terms

    # -- execution ----------------------------------------------------------
    def run_step(self, bs: int, mtl: int) -> dict:
        """Simulate one synchronized step of all MTL instances."""
        mean = self.mean_latency(bs, mtl)
        lat = float(self.sampler.sample(mean, n=1)[0])
        self.clock += lat
        items = bs * mtl
        power, dyn = self.power_terms(bs, mtl)
        return {
            "step_time": lat,
            "items": items,
            "request_latencies": self.sampler.sample(lat, n=min(items, 64)),
            "power_w": power,
            "dynamic_power_w": dyn,
            "throughput": items / lat,
        }

    # -- token engine --------------------------------------------------------
    def token_step_latency(self, live_slots: int, mtl: int = 1,
                           prefill_tenants: int = 0,
                           extra_slots: float = 0.0) -> float:
        """Mean decode-step latency with `live_slots` slots occupied.

        A co-scheduled prefill ("cotenant" prefill mode) is priced as an
        extra spatial tenant on TOP of any configured partition slice —
        the same cross-tenant interference terms the partition model
        calibrates against the paper's MTL curves.

        `extra_slots` ("chunked" prefill mode) piggybacks a prefill chunk
        into the step as fractional decode-token equivalents: the step is
        priced as a batch of `live_slots + extra_slots` on the same grid
        (the grids are float-polymorphic, so 16 + 0.0 prices bit-identical
        to 16 — the default is an exact no-op)."""
        key = (live_slots, mtl, prefill_tenants, extra_slots)
        lat = self._tok_cache.get(key)
        if lat is None:
            ts = self.partition
            lat = float(dm.token_latency_grid(
                self.device, self.profile, [live_slots + extra_slots],
                [mtl],
                inv_share=ts.inv_share if ts is not None else 1.0,
                tenants=(ts.tenants if ts is not None else 1)
                + prefill_tenants,
                isolation=ts.isolation if ts is not None else 0.0)[0, 0])
            self._tok_cache[key] = lat
        return lat

    def run_token_step(self, live_slots: int, mtl: int = 1, *,
                       prefill_tenants: int = 0,
                       extra_slots: float = 0.0) -> dict:
        """Simulate one decode step: every live slot emits one token (a
        nonzero `extra_slots` also advances piggybacked prefill chunks —
        priced into the step, not counted as output tokens)."""
        mean = self.token_step_latency(live_slots, mtl, prefill_tenants,
                                       extra_slots)
        lat = float(self.sampler.sample(mean, n=1)[0])
        self.clock += lat
        tokens = live_slots * mtl
        power, dyn = self.power_terms(live_slots, mtl)
        return {
            "step_time": lat,
            "tokens": tokens,
            "items": tokens,
            "power_w": power,
            "dynamic_power_w": dyn,
            "throughput": tokens / lat,
        }



# Default batch buckets: dense at small sizes (where the scalers live), a
# x1.5 / x2 ladder above — every (bs * mtl) rounds UP to one of these, so a
# probing scaler touches O(log) distinct buckets instead of one per point.
DEFAULT_BUCKETS = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256,
                   384, 512, 768, 1024, 1536, 2048, 3072, 4096)

# fits() activation-estimate multiplier: per-item batch bytes amplified
# through the network (activations, workspace, output buffers).
ACT_MULT = 12.0
PARAM_OVERHEAD = 1.3   # optimizer-free serving copy + allocator slack


def tensor_leaves(tree) -> list:
    """The tensors of a nested dict / list / tuple, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _tree_bytes(tree) -> float:
    return float(sum(x.numel() * x.element_size() for x in tensor_leaves(tree)))


class CudaGraphs:
    """Captures a bucket's run in a CUDA graph: the card's counterpart of
    the reference's ahead-of-time executable.

    Warm-ups and captures run on one side stream, and every bucket's graph
    draws on one memory pool.  That is safe because the buckets replay one
    at a time on one stream and each entry keeps its graph's static input
    and output alive, so only temporaries are shared.  Captured largest
    first, the pool holds about the largest bucket's memory, each smaller
    bucket carving its blocks out of the larger one's; captured in rising
    order, each new largest bucket adds blocks of its own (a block never
    spans two of the allocator's segments), so a caller that warms many
    buckets ahead of serving warms the largest first."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()

    def warm_up(self, run: Callable) -> None:
        """One eager run on the capture stream, ended by a synchronise:
        kernel builds and autotune searches (whose timing captures graphs
        of its own, and a capture cannot be nested) happen here, not inside
        the capture."""
        with torch.cuda.device(self.device):
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                run()
            torch.cuda.synchronize()

    def capture(self, run: Callable) -> tuple:
        """(graph, the run's output): one run captured, not executed; the
        output lives in the pool and is rewritten by every replay."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device):
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                out = run()
            torch.cuda.synchronize()
        return graph, out


def graph_capturer(device: torch.device) -> Optional[CudaGraphs]:
    """What captures a bucket on ``device``: CUDA graphs on a CUDA device;
    nothing on the CPU, where no graph exists and the executor runs
    eagerly."""
    return CudaGraphs(device) if device.type == "cuda" else None


@dataclasses.dataclass
class _Bucket:
    """A warmed bucket.  ``batch`` is what a run reads; under a graph it is
    the graph's static input, read in place by every replay, and ``out``
    the static output; the entry keeps both alive.  ``launches`` holds the
    kernel launches of one replay (the wrappers' counts across the
    capture); ``host`` is the template ``donate_batch`` stages from."""
    batch: dict
    generation: int
    graph: object = None
    out: object = None
    launches: dict = dataclasses.field(default_factory=dict)
    host: Optional[dict] = None
    replays: int = 0


class RealExecutor:
    """Wall-clock executor over a model callable.

    `fn(params, batch)` consumes a batch dict whose tensors have leading
    dim = instances*bs (instances folded in by the caller via make_batch).

    AOT + bucketing: `run_step(bs, mtl)` rounds bs*mtl up to a bucket,
    captures that bucket's run once in a CUDA graph (``aot``, on a CUDA
    device) or warms it up with one eager run, and reuses it for every
    operating point that lands in the bucket (padding rows are masked out
    of the throughput accounting — only real items count).  With
    `donate_batch=True` a fresh batch is staged from a host copy before
    the timer on every step (into the graph's static input, or as a new
    device batch when running eagerly): the real serving path, where every
    request brings new data; by default the bucket's batch is reused.
    `replayed_launches` counts the kernel launches of every replay, which
    the kernel wrappers' own counters do not see.
    """

    def __init__(self, fn: Callable, params, make_batch: Callable,
                 idle_w: float = 50.0, peak_w: float = 250.0, *,
                 mem_bytes: Optional[float] = None,
                 act_bytes_per_item: Optional[float] = None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 donate_batch: bool = False,
                 aot: bool = True,
                 tile_generation: Optional[Callable[[], int]] = None,
                 kv_bytes_per_item: float = 0.0):
        self.fn = fn
        self.params = params
        self.make_batch = make_batch
        self.idle_w = idle_w
        self.peak_w = peak_w
        self.mem_bytes = mem_bytes
        self.act_bytes_per_item = act_bytes_per_item
        self.kv_bytes_per_item = kv_bytes_per_item
        self.buckets = tuple(sorted(buckets))
        self.donate_batch = donate_batch
        self.aot = aot
        # bucket items -> _Bucket; a generation bump makes resident entries
        # stale — evicted and captured again, never served
        self._exec: dict = {}
        self._tile_generation = tile_generation or autotune.generation
        self._param_bytes: Optional[float] = None
        leaves = tensor_leaves(params)
        self.device = leaves[0].device if leaves else torch.device("cpu")
        self._graphs = graph_capturer(self.device) if aot else None
        self.replayed_launches = collections.Counter()  # kernel -> launches
        self.captures = 0                # graphs captured
        self.capture_time_s = 0.0        # of compile_time_s, in captures
        self.cache_stats = ExecCacheStats()
        self._pending_compile = 0.0      # warm-up seconds not yet charged
        self.partition = None            # TenantSlice: capped-batch proxy
        self.clock = 0.0

    def set_partition(self, ts) -> None:
        """Spatial-partition proxy: a slice is emulated by inflating the
        measured wall clock with the slice's calibrated slowdown
        (`TenantSlice.slowdown`); the raw wall measurement is still
        reported (``wall_step_time``)."""
        self.partition = ts

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- capacity -----------------------------------------------------------
    def bucket(self, n: int) -> int:
        """Smallest bucket >= n (or n itself beyond the largest bucket)."""
        for b in self.buckets:
            if b >= n:
                return b
        return n

    @property
    def param_bytes(self) -> float:
        if self._param_bytes is None:    # fits() runs per scaler candidate
            self._param_bytes = _tree_bytes(self.params)
        return self._param_bytes

    def _batch_bytes_per_item(self) -> float:
        if self.act_bytes_per_item is None:
            self.act_bytes_per_item = _tree_bytes(self.make_batch(1)) * ACT_MULT
        return self.act_bytes_per_item

    def fits(self, bs: int, mtl: int) -> bool:
        """Memory-aware admission when a `mem_bytes` budget is configured
        (param bytes + per-item activation estimate at the BUCKETED batch,
        since that is the shape actually run; plus `kv_bytes_per_item` per
        live slot); the historical hard cap `bs * mtl <= 4096` when no
        budget is given."""
        n = bs * mtl
        if self.mem_bytes is None:
            return n <= 4096
        need = (self.param_bytes * PARAM_OVERHEAD
                + self.bucket(n) * self._batch_bytes_per_item()
                + n * self.kv_bytes_per_item)
        return need <= self.mem_bytes

    # -- bucket cache -------------------------------------------------------
    def _get(self, n_bucket: int) -> _Bucket:
        entry = self._exec.get(n_bucket)
        if entry is not None:
            if entry.generation == int(self._tile_generation()):
                self.cache_stats.hits += 1
                return entry
            # built under superseded tile sizes: evict, never serve
            del self._exec[n_bucket]
            self.cache_stats.stale_evictions += 1
        self.cache_stats.misses += 1
        t0 = time.perf_counter()
        batch = self.make_batch(n_bucket)
        host = (_tree_map(lambda x: x.to("cpu", copy=True), batch)
                if self.donate_batch else None)
        run = functools.partial(self.fn, self.params, batch)
        graph = out = None
        launches = {}
        if self._graphs is None:
            run()                        # warm-up: allocator, kernel builds
            self._sync()
        else:
            self._graphs.warm_up(run)
            before = kernels.launch_counts()
            t1 = time.perf_counter()
            graph, out = self._graphs.capture(run)
            self.capture_time_s += time.perf_counter() - t1
            self.captures += 1
            launches = {k: n - before[k]
                        for k, n in kernels.launch_counts().items()
                        if n != before[k]}
        dt = time.perf_counter() - t0
        self.cache_stats.compile_time_s += dt
        self._pending_compile += dt
        # tagged with the generation read AFTER the capture: a tune_on_miss
        # search during the warm-up bumps it, and the graph already uses
        # its result
        entry = _Bucket(batch, int(self._tile_generation()), graph, out,
                        launches, host)
        self._exec[n_bucket] = entry
        return entry

    def _staged(self, entry: _Bucket):
        """The batch a run reads: with ``donate_batch``, a fresh copy of the
        host template, written into the graph's static input or made anew
        for an eager run; else the bucket's batch."""
        if entry.host is None:
            return entry.batch
        if entry.graph is None:
            return _tree_map(lambda x: x.to(self.device, copy=True),
                             entry.host)
        for dst, src in zip(tensor_leaves(entry.batch),
                            tensor_leaves(entry.host)):
            dst.copy_(src)
        return entry.batch

    def _run(self, entry: _Bucket, batch) -> None:
        if entry.graph is None:
            self.fn(self.params, batch)
            return
        entry.graph.replay()
        entry.replays += 1
        self.replayed_launches.update(entry.launches)

    # -- migration instrumentation -------------------------------------------
    def shutdown(self) -> float:
        """Drop the warmed-up buckets and their graphs (the 'kill' half of
        a migration's kill+relaunch round) and return the seconds it
        took."""
        t0 = time.perf_counter()
        self._sync()
        self._exec.clear()
        self._pending_compile = 0.0
        return time.perf_counter() - t0

    def warmup(self, bs: int, mtl: int) -> float:
        """Warm up (and on the card capture) the bucket for (bs, mtl) ahead
        of serving and return the seconds it took (0.0 on a cache hit).
        The pending charge is consumed here so the caller charging it as a
        stall does not double-charge the next step."""
        self._get(self.bucket(bs * mtl))
        dt = self._pending_compile
        self._pending_compile = 0.0
        return dt

    # -- pricing ------------------------------------------------------------
    def mean_latency(self, bs: int, mtl: int, iters: int = 3) -> float:
        entry = self._get(self.bucket(bs * mtl))
        if entry.graph is None:
            batches = [self._staged(entry) for _ in range(iters)]
        else:
            batches = [self._staged(entry)] * iters     # one static input
        self._sync()
        t0 = time.perf_counter()
        for batch in batches:
            self._run(entry, batch)
        self._sync()
        wall = (time.perf_counter() - t0) / iters
        if self.partition is not None:
            return wall * self.partition.proxy_slowdown()
        return wall

    # -- execution ----------------------------------------------------------
    def run_step(self, bs: int, mtl: int) -> dict:
        nb = self.bucket(bs * mtl)
        entry = self._get(nb)
        comp = self._pending_compile
        self._pending_compile = 0.0
        batch = self._staged(entry)
        self._sync()
        t0 = time.perf_counter()
        self._run(entry, batch)
        self._sync()
        wall = time.perf_counter() - t0
        slowdown = (self.partition.proxy_slowdown()
                    if self.partition is not None else 1.0)
        lat = wall * slowdown
        if entry.generation != int(self._tile_generation()):
            # a tuning landed between the cache lookup and this serve: count
            # it (steady-state serving asserts ZERO) and evict
            self.cache_stats.stale_hits += 1
            self._exec.pop(nb, None)
        self.clock += lat + comp
        items = bs * mtl                 # bucket padding rows do not count
        return {
            "step_time": lat,
            "items": items,
            "compile_time": comp,
            "bucket_items": nb,
            "wall_step_time": wall,
            "partition_slowdown": slowdown,
            "request_latencies": np.full(min(items, 64), lat),
            "power_w": self.peak_w * 0.6,
            "dynamic_power_w": max(self.peak_w * 0.6 - self.idle_w, 0.0),
            "throughput": items / lat,
        }

    # -- token engine --------------------------------------------------------
    def run_token_step(self, live_slots: int, mtl: int = 1, *,
                       prefill_tenants: int = 0,
                       extra_slots: float = 0.0) -> dict:
        """One measured decode step with `live_slots` slots occupied: the
        callable IS the decode-step function (``launch.serve.
        decode_executor_for``), and the bucket ladder doubles as the slot
        ladder (a step at 13 live slots replays the 16-slot bucket; padding
        slots don't count as tokens).  A co-resident prefill on this
        single-process host shares the clock it is measured on, so no
        pricing term is added for `prefill_tenants`.  Chunked-prefill
        `extra_slots` widen the measured batch (rounded up to whole rows)
        without counting as output tokens."""
        width = live_slots + int(np.ceil(extra_slots))
        r = self.run_step(width, mtl)
        r["tokens"] = live_slots * mtl
        r["items"] = r["tokens"]
        return r
