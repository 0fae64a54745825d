"""Run one cell of the benchmark once and print its result line.

    python3 -m bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up (the weights drawn on the card from
the seed, the kernels built into ``build/kernels/`` or loaded from there,
every bucket the controller can reach captured, the Profiler's probes) is
``setup_s``; then the engine serves for ``--seconds``.  ``--trace 0``
reports the end-to-end metrics; ``--trace 1`` the per-layer ones, with
the device trace of the steps served right after the window.  Then the
served tokens are checked against the float32 reference.  The last line
of standard output is one JSON object; the numbers compared, each with its
limit, are the last lines of standard error.  Without a card it exits 2
and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
TRACE_S = 0.5             # the least host time the traced steps cover
TRACE_STEPS = (2, 40)     # the fewest and most steps traced


def _environment() -> None:
    """Caches at fixed paths inside the checkout (the program builds its
    kernels into ``build/kernels/`` itself); the program's package on the
    path; no tuning store is read or written."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["REPRO_PROFILE_STORE"] = str(cache / "profile_store")
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(cache / "profile_store")
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, taken whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _traced(served, win, ctrl, ctx, readers: dict) -> dict:
    """Serve a few more steps under torch.profiler and read the per-layer
    metrics from the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench.context import Trace
    from bench.serve import CONTROLLER, STEP

    mean = win.seconds / len(win.steps)
    k = max(TRACE_STEPS[0], min(TRACE_STEPS[1], math.ceil(TRACE_S / mean)))
    served.timed.steps = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        win.engine.run(ctrl, max_steps=k)
        torch.cuda.synchronize()
    dev, host = [], []
    for e in prof.events():
        r = e.time_range
        if e.name in (STEP, CONTROLLER):
            if e.device_type == torch.autograd.DeviceType.CPU:
                host.append((e.name, r.start, r.end))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((e.name, r.start, r.end))
    steps = sorted((s, e) for n, s, e in host if n == STEP)
    ctx.trace = Trace(dev, steps[0][0], steps[-1][1],
                      list(served.timed.steps), host)
    return {n: read(ctx) for n, read in readers.items()}


def _by_bucket(steps) -> dict:
    """Per bucket the window served: steps, requests, and the median and
    largest step ms."""
    import statistics
    out = {}
    for b in sorted({s.bucket for s in steps}):
        ms = [(s.t1 - s.t0) * 1e3 for s in steps if s.bucket == b]
        out[b] = [len(ms), sum(s.items for s in steps if s.bucket == b),
                  round(statistics.median(ms), 3), round(max(ms), 3)]
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda") -> tuple:
    """(result, checks, notes): the result line's object, the numbers
    compared with their limits, and what the run saw."""
    import torch

    from bench import check, spec
    from bench.context import Context
    from bench.serve import Served, serve_window
    from repro_torch.perf import autotune

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    autotune.configure(enabled=False)
    served = Served(cell, seed, device)
    served.warm()
    slo_s = cell.knobs["slo_ms"] / 1e3
    ctrl = served.controller(slo_s)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    win = serve_window(served, ctrl, slo_s, seconds)
    ctx = Context(cell.conf, cell.traffic, cell.knobs, slo_s, win.steps,
                  win.seconds, win.host_s)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1}
    result = {"correct": False, "attempted": ctx.requests, "failed": 0}
    if trace:
        values = _traced(served, win, ctrl, ctx, {
            m["name"]: spec.metric_reader(m["name"]) for m in cell.per_layer})
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.per_layer if values[m["name"]] is not None}
        dev["busy_s"] = ctx.trace.busy_us / 1e6
        dev["window_s"] = ctx.trace.span_us / 1e6
        result["breakdown"] = ctx.trace.breakdown()
    else:
        e2e = {"goodput_rps": ctx.good / ctx.window_s, "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[spec.quantity(m["name"], e2e)],
                               "unit": m["unit"]} for m in cell.end_to_end}
    dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    act = ctrl.controller.action()
    notes = {"approach": ctrl.controller.approach,
             "steady": [act.bs, act.mtl], "steps": len(win.steps),
             "window_s": win.seconds, "requests": ctx.requests,
             "good": ctx.good, "setup_s": setup_s,
             "buckets": len(served.buckets),
             "by_bucket": _by_bucket(win.steps),
             "capture_s": served.executor.capture_time_s}

    # the check: the served tokens against the reference, once the
    # program's graphs and buffers are freed
    traced = ctx.trace.steps if ctx.trace is not None else []
    picks = check.sample(win.steps + traced, seed,
                         cell.traffic["check_requests"])
    prompt, tokens = check.served(served.timed, picks)
    served.executor.shutdown()
    del ctrl, win
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gaps = check.gaps(cell.conf, served.weights.params, prompt, tokens,
                      device)
    notes["check_s"] = time.perf_counter() - t0
    limit = cell.knobs["check"]["widest_gap_limit"]
    widest = float(gaps.max())
    result.update(correct=widest <= limit, failed=int((gaps > limit).sum()),
                  metrics=metrics, device=dev)
    checks = {"widest_gap": {"value": widest, "limit": limit,
                             "tokens": int(tokens.numel())}}
    return result, checks, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from bench import spec

    cell = spec.load_cell(args.workload)
    need = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"bench: {args.workload} needs {need} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; nothing runs on the CPU", file=sys.stderr)
        return 2
    result, checks, notes = run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace), T_START)
    found = forbidden_modules()
    if found:
        print(f"bench: modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    result["checks"] = checks
    print(json.dumps({"notes": notes}), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
