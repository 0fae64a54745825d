"""The warm start's stall seconds (``examples/warm_start.py``), cold run
then warm run on a fresh store, repeated: each bucket miss and each of
the interpreter's collections timed, in four settings (a small heap; a
heap of 3M tracked objects; that heap with the collector off during each
run and the allocator's cache emptied before it; that heap with the
cache emptied only).  Prints each pair and, per setting, the pairs in
which the warm run stalled as long as the cold run or longer.

    python3 tools/chip_probes/warm_start_stalls.py [PAIRS] [DEVICE]
"""
import gc
import json
import pathlib
import statistics
import sys
import tempfile
import time
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))
import torch  # noqa: E402
from repro_torch.examples import warm_start as ws  # noqa: E402
from repro_torch.serving import executor as exm  # noqa: E402

DEV = torch.device(sys.argv[2] if len(sys.argv) > 2 else "cuda")
misses = []            # (t0, t1) of every miss
_get = exm.RealExecutor._get
def timed_get(self, n):
    hit = n in self._exec
    t0 = time.perf_counter(); e = _get(self, n); t1 = time.perf_counter()
    if not hit: misses.append((t0, t1))
    return e
exm.RealExecutor._get = timed_get
gcs = []; _st = {}
def cb(phase, info):
    if phase == "start": _st["t"] = time.perf_counter()
    else: gcs.append((_st["t"], time.perf_counter(), info["generation"]))
gc.callbacks.append(cb)

def one_run(store, settle, nogc):
    if settle:
        gc.collect()
        if DEV.type == "cuda": torch.cuda.synchronize(); torch.cuda.empty_cache()
    misses.clear(); gcs.clear()
    if nogc: gc.disable()
    try:
        r = ws.serve_once(store, device=DEV)
    finally:
        if nogc: gc.enable()
    inside = sum(min(g1, m1) - max(g0, m0) for g0, g1, _ in gcs
                 for m0, m1 in misses if g0 < m1 and m0 < g1)
    return {"stall_ms": r["compile_stall_s"] * 1e3, "captures": r["compiles"],
            "miss_ms": [round((b - a) * 1e3, 3) for a, b in misses],
            "gc_n": len(gcs), "gc_gen2": sum(g == 2 for *_, g in gcs),
            "gc_ms": round(sum(b - a for a, b, _ in gcs) * 1e3, 3),
            "gc_in_miss_ms": round(inside * 1e3, 3)}

def regime(name, pairs, settle, nogc):
    lab = ws.WarmLabExecutor(ws.JOB.profile(), torch_device=DEV)
    for n in lab.buckets: lab.warmup(n, 1)
    del lab
    res = []
    for _ in range(pairs):
        with tempfile.TemporaryDirectory() as s:
            c = one_run(s, settle, nogc); w = one_run(s, settle, nogc)
        res.append((c, w))
    fails = sum(w["stall_ms"] >= c["stall_ms"] for c, w in res)
    ratio = [w["stall_ms"] / c["stall_ms"] for c, w in res]
    print(f"[{name}] objects tracked {len(gc.get_objects())}; pairs {pairs}, "
          f"warm >= cold in {fails}; ratio median {statistics.median(ratio):.3f} "
          f"min {min(ratio):.3f} max {max(ratio):.3f}", flush=True)
    for c, w in res:
        print(f"  cold {c['stall_ms']:.2f} ms/{c['captures']} (max miss {max(c['miss_ms']):.2f}, gc {c['gc_n']}/{c['gc_gen2']} {c['gc_ms']:.2f} ms, in misses {c['gc_in_miss_ms']:.2f}) | "
              f"warm {w['stall_ms']:.2f} ms/{w['captures']} (max miss {max(w['miss_ms']):.2f}, gc {w['gc_n']}/{w['gc_gen2']} {w['gc_ms']:.2f} ms, in misses {w['gc_in_miss_ms']:.2f})", flush=True)
    print("  last pair misses:", res[-1][0]["miss_ms"], res[-1][1]["miss_ms"], flush=True)
    return fails

P = int(sys.argv[1]) if len(sys.argv) > 1 else 10
out = {}
out["small heap"] = regime("small heap", P, False, False)
heap = [{"k": i, "v": [i]} for i in range(1_500_000)]
out["big heap"] = regime("big heap", P, False, False)
out["big heap, settled, no gc in runs"] = regime("big heap, settled, no gc", P, True, True)
out["big heap, settled, gc on"] = regime("big heap, settled, gc on", P, True, False)
print(json.dumps(out))
