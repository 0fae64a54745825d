"""Kernel autotuner: per-(kernel, shape class, dtype, backend) search over
the knob each Hopper kernel takes, with roofline-guided candidate pruning
and a persistent cache in the profile store.

Counterpart of ``repro.perf.autotune``, with its public API and its shape
classes (dims bucketed to powers of two, so one tuning covers a
neighbourhood of shapes).  The knobs are the Hopper kernels':

  * ``paged_decode_attention``: the page size, 32 to 256 keys up to S.  It
    is a layout knob, so each candidate is timed on a pool built at that
    page size (``_paged_bench``), through the paged kernel;
  * ``decode_attention``: the split-K kernel's ``split_len``, 64 to 1024
    keys up to S, plus ``split_plan``'s choice for the class, the default;
  * ``ssd_scan``: the SSD-scan kernel's ``chunk``, 32 to 256 dividing T;
  * ``flash_attention``: on the card, the (``block_q``, ``block_k``) tile
    of the flash kernel's wgmma body for the bf16 classes at head_dim 64,
    128 and 256 that body takes: 64 or 128 each, and at head_dim 256 the
    two 64-key tiles (a 128-key tile overflows shared memory there); every
    other class reaches a body with one tile (``fixed_tile``: 64 rows of
    query positions times the GQA group, by 64 keys), so it has one
    candidate and ``tune`` only records its time.  On the CPU the
    candidates are the block sizes of the plain blockwise flash
    (``models.layers.flash_attention``), the reference's list; only there
    does the plain flash read them.  A tuned tile is the wgmma body's
    alone: a call of the class that another body takes (a view off the
    16-byte rule) runs at that body's tile.

A candidate is priced at max(FLOPs / peak, bytes / memory rate) over the
card's constants (``perf.roofline``), divided by the share of the 132 SMs
its grid fills; one whose shared memory exceeds a block's 227 KB is
dropped, and the default always survives.  The survivors are timed: one
warm-up call (where a kernel is first built, so no build is timed), then
the median of ``iters`` runs.  On the card a run replays ``GRAPH_CALLS``
calls captured in a CUDA graph between two CUDA events, so only the
device's time counts; on the CPU a run is one call on the host clock.

The backend key is ``torch-cpu`` or ``torch-cuda:<device name>``, so an
entry never crosses between the CPU and a card, and never collides with
the reference's entries (keyed ``cpu`` or ``tpu``) when both packages use
one store.  Results persist in the ``autotune`` section of the profile
store (``perf.profile_store``) under ``configure(cache_dir=...)``,
``REPRO_AUTOTUNE_CACHE``, ``REPRO_PROFILE_STORE`` or ``.profile_store/``.
Every persisted tuning bumps the store's ``autotune`` generation, which
``RealExecutor`` keys its warmed buckets on.  The kernel wrappers consult
``lookup`` when the caller passes no knob: an explicit keyword wins, and
an empty cache gives the kernels' own defaults.  ``lookup`` runs on every
eager decode step, so its answer is memoised per call, and the memo is
cleared by ``configure`` and by every persisted tuning: a hit is one dict
lookup.  ``tune_on_miss`` (off by default) lets
``serve --autotune`` fill the cache.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.kernels.decode_attention import decode_attention as _k2
from repro_torch.kernels.decode_attention import \
    paged_decode_attention as _k3
from repro_torch.kernels.flash_attention import flash_attention as _k1
from repro_torch.kernels.ssd_scan import ssd_scan as _k4
from repro_torch.perf import profile_store
from repro_torch.perf.roofline import (BF16_FLOPS, F32_FLOPS, HBM_BPS,
                                       NUM_SMS, SMEM_PER_BLOCK)

PRUNE_RATIO = 3.0               # keep candidates within this factor of the
                                # best modeled bound time

# The wrappers' defaults on an empty cache, always kept in the candidate
# set so that tuning can only improve on them.  ``split_len: None`` is
# ``split_plan``'s choice for the shape; on the card the flash kernel's
# default is its wgmma body's default tile, or the one tile of the body a
# class reaches (``_default``); the flash entry here is the plain
# blockwise flash's, on the CPU.
DEFAULTS = {
    "flash_attention": {"block_q": 128, "block_k": 128},
    "decode_attention": {"split_len": None},
    "paged_decode_attention": {"page_size": 64},
    "ssd_scan": {"chunk": 128},
}

_state = {
    "cache_dir": None,            # resolved lazily (env var wins)
    "tune_on_miss": False,
    "enabled": True,
    "hits": 0,
    "misses": 0,
    "timings": 0,                 # individual candidate timings run
    "tunes": 0,                   # full searches run
}
_MEMO: dict = {}                  # lookup call -> config (or None)
_BACKENDS: dict = {}              # torch.device -> backend key


def configure(cache_dir: Optional[str] = None,
              tune_on_miss: Optional[bool] = None,
              enabled: Optional[bool] = None) -> None:
    """Set autotuner behavior; any argument left None is unchanged."""
    if cache_dir is not None:
        _state["cache_dir"] = cache_dir
        _store().reload()         # re-read from the (possibly new) location
    if tune_on_miss is not None:
        _state["tune_on_miss"] = tune_on_miss
    if enabled is not None:
        _state["enabled"] = enabled
    _MEMO.clear()


def cache_dir() -> str:
    return (_state["cache_dir"] or os.environ.get("REPRO_AUTOTUNE_CACHE")
            or profile_store.default_root())


def cache_path() -> str:
    return os.path.join(cache_dir(), profile_store.STORE_FILE)


def _store() -> profile_store.ProfileStore:
    return profile_store.store_for(cache_dir())


def generation() -> int:
    """The resident tuned-knob generation: bumped on every persisted
    tuning.  ``RealExecutor`` keys its warmed buckets on it, so a new
    tuning evicts buckets warmed under the old knobs."""
    return _store().generation("autotune")


def cache_stats() -> dict:
    return {"entries": len(_load()), "hits": _state["hits"],
            "misses": _state["misses"], "timings": _state["timings"],
            "tunes": _state["tunes"], "generation": generation(),
            "cache_dir": cache_dir()}


def reset_counters() -> None:
    _state.update(hits=0, misses=0, timings=0, tunes=0)


def _load() -> dict:
    return _store().section("autotune")


def backend_key(device) -> str:
    """``torch-cpu``, or ``torch-cuda:<device name>`` for a card."""
    dev = torch.device(device)
    key = _BACKENDS.get(dev)
    if key is None:
        key = (f"torch-cuda:{torch.cuda.get_device_name(dev)}"
               if dev.type == "cuda" else f"torch-{dev.type}")
        _BACKENDS[dev] = key
    return key


def _on_card(device) -> bool:
    return device is None or torch.device(device).type == "cuda"


def _bucket(n: int, floor: int = 8) -> int:
    """Next power of two >= n: one tuning run per shape neighborhood."""
    b = floor
    while b < n:
        b *= 2
    return b


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _itemsize(dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


# ---------------------------------------------------------------------------
# Shape classes: the cache key dims per kernel (bucketed where continuous).
# ---------------------------------------------------------------------------
def shape_class(kernel: str, **dims) -> dict:
    if kernel == "flash_attention":
        return {"BKV": _bucket(dims.get("BKV", 1), 1),
                "G": dims["G"], "hd": dims["hd"],
                "Tq": _bucket(dims["Tq"]), "Tk": _bucket(dims["Tk"]),
                "causal": bool(dims["causal"])}
    if kernel == "decode_attention":
        return {"BKV": _bucket(dims.get("BKV", 1), 1),
                "G": dims["G"], "hd": dims["hd"], "S": _bucket(dims["S"])}
    if kernel == "paged_decode_attention":
        # S is the per-slot sequence budget the paged cache is sized for
        return {"BKV": _bucket(dims.get("BKV", 1), 1),
                "G": dims["G"], "hd": dims["hd"], "S": _bucket(dims["S"])}
    if kernel == "ssd_scan":
        return {"H": _bucket(dims.get("H", 1), 1),
                "P": dims["P"], "N": dims["N"], "T": _bucket(dims["T"])}
    raise KeyError(kernel)


def _key(kernel: str, backend: str, dtype: str, cls: dict) -> str:
    dims = ",".join(f"{k}={v}" for k, v in sorted(cls.items()))
    return f"{kernel}|{backend}|{dtype}|{dims}"


# ---------------------------------------------------------------------------
# Candidates, and the roofline model of each: (bound seconds, shared-memory
# bytes per block).  The decode kernels' math runs on the CUDA cores; the
# flash kernel's bf16 body and the SSD scan run on the tensor cores.
# ---------------------------------------------------------------------------
def _k1_tile(G: int) -> dict:
    """The one tile of the flash kernel's mma_sync and CUDA-core bodies."""
    return dict(zip(("block_q", "block_k"), _k1.fixed_tile(G)))


def _k1_wgmma(cls: dict, dtype: str, on_card: bool) -> bool:
    """Whether the class reaches the flash kernel's wgmma body."""
    return on_card and _k1.wgmma_class(dtype, cls["hd"])


def _default(kernel: str, cls: dict, on_card: bool,
             dtype: str = "float32") -> dict:
    if kernel == "flash_attention" and on_card:
        if _k1_wgmma(cls, dtype, on_card):
            return dict(zip(("block_q", "block_k"), _k1.DEFAULT_TILE))
        return _k1_tile(cls["G"])
    if kernel == "decode_attention":
        return {"split_len": _k2.split_plan(cls["BKV"], cls["S"])[0]}
    return dict(DEFAULTS[kernel])


def _bound(flops: float, peak: float, nbytes: float, blocks: int) -> float:
    """max(FLOPs / peak, bytes / memory rate), divided by the share of the
    SMs that ``blocks`` fill."""
    fill = min(blocks / NUM_SMS, 1.0)
    return max(flops / peak, nbytes / HBM_BPS) / fill


def _flash_candidates(cls: dict, on_card: bool,
                      dtype: str = "float32") -> list:
    if _k1_wgmma(cls, dtype, on_card):
        return [{"block_q": bq, "block_k": bk}
                for bq, bk in _k1.TILES[cls["hd"]]]
    if on_card:
        return [_k1_tile(cls["G"])]
    out = []
    for bq in (32, 64, 128, 256):
        for bk in (32, 64, 128, 256):
            if bq <= cls["Tq"] and bk <= cls["Tk"]:
                out.append({"block_q": bq, "block_k": bk})
    return out or [dict(DEFAULTS["flash_attention"])]


def _flash_model(cls: dict, cand: dict, sz: int,
                 on_card: bool = True) -> tuple:
    BKV, G, hd, Tq, Tk = (cls["BKV"], cls["G"], cls["hd"], cls["Tq"],
                          cls["Tk"])
    bq, bk = cand["block_q"], cand["block_k"]
    nq = math.ceil(Tq / bq)
    # q and o once; K and V once per query tile
    nbytes = BKV * sz * (2 * G * Tq * hd + 2 * Tk * hd * nq)
    flops = 4.0 * BKV * G * Tq * Tk * hd * (0.5 if cls["causal"] else 1.0)
    peak = BF16_FLOPS if sz == 2 else F32_FLOPS
    if _k1_wgmma(cls, "bfloat16" if sz == 2 else "float32", on_card):
        # one block per (query tile, head)
        return (_bound(flops, peak, nbytes, BKV * G * nq),
                _k1.wgmma_smem(hd, bq, bk))
    smem = 4 * (G * bq * hd + bk * (hd + 1) + bk * hd)
    return _bound(flops, peak, nbytes, BKV * nq), smem


def _decode_candidates(cls: dict, on_card: bool,
                       dtype: str = "float32") -> list:
    out = [{"split_len": n} for n in (64, 128, 256, 512, 1024)
           if n <= cls["S"]]
    default = _default("decode_attention", cls, on_card)
    return out + ([default] if default not in out else [])


def _decode_model(cls: dict, cand: dict, sz: int,
                  on_card: bool = True) -> tuple:
    BKV, G, hd, S = cls["BKV"], cls["G"], cls["hd"], cls["S"]
    ns = math.ceil(S / cand["split_len"])
    # one launch: the cache, q and o once; the splits merge in shared
    # memory, so no partials move
    nbytes = BKV * sz * (2 * S * hd + 2 * G * hd)
    flops = 4.0 * BKV * G * S * hd
    return (_bound(flops, F32_FLOPS, nbytes, _k2.blocks(BKV, G, ns)),
            _k2.smem_bytes(sz, hd, G))


def _paged_candidates(cls: dict, on_card: bool,
                      dtype: str = "float32") -> list:
    out = [{"page_size": p} for p in (32, 64, 128, 256) if p <= cls["S"]]
    return out or [dict(DEFAULTS["paged_decode_attention"])]


def _paged_model(cls: dict, cand: dict, sz: int,
                 on_card: bool = True) -> tuple:
    BKV, G, hd, S = cls["BKV"], cls["G"], cls["hd"], cls["S"]
    psz = cand["page_size"]
    ns = max(S // psz, 1)
    _, n_split = _k3.split_plan(BKV, ns, psz)
    keys = ns * psz
    # one launch: the live pages, q and o once, and the block table; the
    # splits merge in shared memory, so no partials move
    nbytes = BKV * (sz * (2 * keys * hd + 2 * G * hd) + 4 * ns)
    flops = 4.0 * BKV * G * keys * hd
    return (_bound(flops, F32_FLOPS, nbytes, _k3.blocks(BKV, G, n_split)),
            _k3.smem_bytes(sz, hd, G))


def _ssd_candidates(cls: dict, on_card: bool,
                    dtype: str = "float32") -> list:
    out = [{"chunk": c} for c in (32, 64, 128, 256)
           if c <= cls["T"] and cls["T"] % c == 0]
    return out or [dict(DEFAULTS["ssd_scan"])]


def _ssd_model(cls: dict, cand: dict, sz: int,
               on_card: bool = True) -> tuple:
    H, P, N, T = cls["H"], cls["P"], cls["N"], cls["T"]
    c = cand["chunk"]
    # one sequence: the bytes and products the kernel needs, each product
    # at the peak of the tensor-core unit it runs on; the output kernel's
    # grid, (64-row tiles, groups of 4 heads, chunks), decides the fill
    nbytes, work = _k4.work(1, T, H, P, N, c, sz, sz)
    t_ops = sum(flops / peak for flops, peak in work)
    blocks = -(-c // _k4.TILE) * -(-H // _k4.HEADS_PER_BLOCK) * (T // c)
    fill = min(blocks / NUM_SMS, 1.0)
    return (max(t_ops, nbytes / HBM_BPS) / fill,
            _k4.smem_bytes(sz, sz, P, N, c))


_KERNELS: dict = {
    "flash_attention": (_flash_candidates, _flash_model),
    "decode_attention": (_decode_candidates, _decode_model),
    "paged_decode_attention": (_paged_candidates, _paged_model),
    "ssd_scan": (_ssd_candidates, _ssd_model),
}


def prune_candidates(kernel: str, cls: dict, dtype: str,
                     ratio: float = PRUNE_RATIO, *, device=None) -> list:
    """Roofline-guided pruning: drop candidates whose modeled bound time
    is worse than `ratio` x the best model, or whose shared memory cannot
    fit a block.  The default survives unconditionally: pruning may only
    ever remove challengers, never the fallback."""
    on_card = _on_card(device)
    cands_fn, model_fn = _KERNELS[kernel]
    dtype = _dtype_name(dtype)
    cands = cands_fn(cls, on_card, dtype)
    sz = _itemsize(dtype)
    scored = [(cand, *model_fn(cls, cand, sz, on_card)) for cand in cands]
    feasible = [s for s in scored if s[2] <= SMEM_PER_BLOCK] or scored
    best = min(b for _, b, _ in feasible)
    kept = [c for c, b, _ in feasible if b <= ratio * best]
    default = _default(kernel, cls, on_card, dtype)
    if all(c != default for c in kept) and default in cands:
        kept.append(default)
    return kept


# ---------------------------------------------------------------------------
# Timing: the public wrappers, so the card runs the kernels and the CPU
# their plain versions.
# ---------------------------------------------------------------------------
GRAPH_CALLS = 10                # calls captured in the graph a run replays


def _time_call(fn: Callable, device: torch.device, iters: int = 3) -> float:
    """Seconds per call: one warm-up call, then the median of ``iters``
    timed runs, so one spike does not decide.  On the card a run is one
    replay, between two CUDA events, of ``GRAPH_CALLS`` calls captured once
    in a CUDA graph: the device's time alone, not the wrapper's host work,
    which at small shapes takes longer than the kernel and would decide
    between candidates that differ only on the device.  A call that cannot
    be captured raises.  On the CPU a run is one call on the host clock."""
    fn()
    times = []
    if device.type == "cuda":
        with torch.cuda.device(device):
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(GRAPH_CALLS):
                    fn()
            for _ in range(iters):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                graph.replay()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b) / 1e3 / GRAPH_CALLS)
            del graph
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    _state["timings"] += 1
    times.sort()
    return times[len(times) // 2]


def _randn(gen, shape, device, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen, device=device)
            * scale).to(dtype)


def flash_inputs(cls: dict, dtype, device) -> tuple:
    """(q, k, v) on which the flash kernel is timed for ``cls``: the batch
    and the kv heads folded into one batch of BKV."""
    B = cls["BKV"]
    G, hd, Tq, Tk = cls["G"], cls["hd"], cls["Tq"], cls["Tk"]
    gen = torch.Generator(device=device).manual_seed(0)
    q = _randn(gen, (B, Tq, G, hd), device, dtype)
    k = _randn(gen, (B, Tk, 1, hd), device, dtype)
    v = _randn(gen, (B, Tk, 1, hd), device, dtype)
    return q, k, v


def _flash_bench(cls: dict, dtype, cand: dict, device) -> Callable:
    q, k, v = flash_inputs(cls, dtype, device)
    if device.type == "cuda":
        from repro_torch.kernels.flash_attention.ops import flash_attention
        return lambda: flash_attention(q, k, v, causal=cls["causal"],
                                       block_q=cand["block_q"],
                                       block_k=cand["block_k"])
    from repro_torch.models.layers import flash_attention as plain_flash
    return lambda: plain_flash(q, k, v, causal=cls["causal"],
                               block_q=cand["block_q"],
                               block_k=cand["block_k"])


def _decode_bench(cls: dict, dtype, cand: dict, device) -> Callable:
    from repro_torch.kernels.decode_attention.ops import decode_attention
    B, G, hd, S = cls["BKV"], cls["G"], cls["hd"], cls["S"]
    gen = torch.Generator(device=device).manual_seed(1)
    q = _randn(gen, (B, G, hd), device, dtype)
    kc = _randn(gen, (B, S, 1, hd), device, dtype)
    vc = _randn(gen, (B, S, 1, hd), device, dtype)
    pos = torch.tensor([S - 1], dtype=torch.int32, device=device)
    return lambda: decode_attention(q, kc, vc, pos,
                                    split_len=cand["split_len"])


def paged_inputs(cls: dict, dtype, page_size: int, device) -> tuple:
    """(q, k_pages, v_pages, kv_lens, block_tables) on which the paged
    kernel is timed for ``cls`` at ``page_size``: every slot full, its
    pages in order in a pool of that page size."""
    B, G, hd, S = cls["BKV"], cls["G"], cls["hd"], cls["S"]
    npages = max(S // page_size, 1)
    P = B * npages
    gen = torch.Generator(device=device).manual_seed(3)
    q = _randn(gen, (B, G, hd), device, dtype)
    kp = _randn(gen, (P, page_size, 1, hd), device, dtype)
    vp = _randn(gen, (P, page_size, 1, hd), device, dtype)
    tbl = torch.arange(P, dtype=torch.int32, device=device).reshape(B, npages)
    lens = torch.full((B,), S, dtype=torch.int32, device=device)
    return q, kp, vp, lens, tbl


def _paged_bench(cls: dict, dtype, cand: dict, device) -> Callable:
    # the candidate page size changes the INPUT layout (the pool is built
    # at that granularity), so each candidate is timed end to end on its
    # own pool: that is the decision made once at cache construction
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    args = paged_inputs(cls, dtype, cand["page_size"], device)
    return lambda: paged_decode_attention(*args)


def _ssd_bench(cls: dict, dtype, cand: dict, device) -> Callable:
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    H, P, N, T = cls["H"], cls["P"], cls["N"], cls["T"]
    gen = torch.Generator(device=device).manual_seed(2)
    x = _randn(gen, (1, T, H, P), device, dtype, 0.5)  # x, B and C in
    dt = torch.nn.functional.softplus(_randn(gen, (1, T, H), device))
    A = -torch.exp(_randn(gen, (H,), device, scale=0.5))
    Bm = _randn(gen, (1, T, N), device, dtype, 0.5)   # `dtype`, as the model
    Cm = _randn(gen, (1, T, N), device, dtype, 0.5)   # passes them
    return lambda: ssd_scan(x, dt, A, Bm, Cm, chunk=cand["chunk"])


_BENCH = {"flash_attention": _flash_bench, "decode_attention": _decode_bench,
          "paged_decode_attention": _paged_bench, "ssd_scan": _ssd_bench}


# ---------------------------------------------------------------------------
# Public API: lookup (cache only, unless tune_on_miss) and tune (search).
# ---------------------------------------------------------------------------
def lookup(kernel: str, dtype, *, device=None, **dims) -> Optional[dict]:
    """Best-known knob for this call site on ``device`` (the card unless
    given), or None (the caller takes its default).  Cache-only unless
    ``tune_on_miss``."""
    if not _state["enabled"]:
        return None
    call = (kernel, device, dtype, tuple(sorted(dims.items())))
    if call in _MEMO:
        cfg = _MEMO[call]
    else:
        dev, name = resolve_device(device), _dtype_name(dtype)
        cls = shape_class(kernel, **dims)
        entry = _load().get(_key(kernel, backend_key(dev), name, cls))
        cfg = entry["config"] if entry is not None else None
        if cfg is None and _state["tune_on_miss"]:
            _state["misses"] += 1
            return tune(kernel, name, device=dev, **dims)["config"]
        _MEMO[call] = cfg
    _state["hits" if cfg is not None else "misses"] += 1
    return cfg


def tune(kernel: str, dtype="float32", *, device=None, force: bool = False,
         iters: int = 3, prune: bool = True, **dims) -> dict:
    """Search one shape class on ``device`` (the card unless given);
    persist and return the cache entry {config, us_per_call, default_us,
    backend, shape_class, candidates_timed}."""
    dev = resolve_device(device)
    dtype = _dtype_name(dtype)
    cls = shape_class(kernel, **dims)
    backend = backend_key(dev)
    key = _key(kernel, backend, dtype, cls)
    mem = _load()
    if not force and key in mem:
        return mem[key]
    _state["tunes"] += 1
    on_card = dev.type == "cuda"
    cands = (prune_candidates(kernel, cls, dtype, device=dev) if prune
             else _KERNELS[kernel][0](cls, on_card, dtype))
    tdtype = getattr(torch, dtype)
    best, best_t, timed = None, float("inf"), {}
    for cand in cands:
        t = _time_call(_BENCH[kernel](cls, tdtype, cand, dev), dev,
                       iters=iters)
        timed[json.dumps(cand, sort_keys=True)] = t * 1e6
        if t < best_t:
            best, best_t = cand, t
    default = _default(kernel, cls, on_card, dtype)
    entry = {
        "config": dict(best),
        "us_per_call": best_t * 1e6,
        "default_us": timed.get(json.dumps(default, sort_keys=True)),
        "backend": backend,
        "shape_class": cls,
        "candidates_timed": timed,
    }
    mem[key] = entry
    # buckets warmed under older knobs are stale: bumping the generation
    # makes RealExecutor's cache key miss them
    _store().bump_generation("autotune")
    _store().save()
    _MEMO.clear()
    return entry
