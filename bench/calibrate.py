"""Measure a cell's SLO rule once: 4 x the bs=1 request's latency, as the
program's ``serve_real`` takes it (``RealExecutor.mean_latency(1, 1)``:
the bucket-1 graph replayed with its prompt staged, on the host clock),
the median of ``--repeats`` readings of 10 replays each.

    python3 -m bench.calibrate --workloads a,b --seed <n>

Prints one JSON line per cell; the value is then frozen in the cell's
``bench/workloads/<name>.json`` as ``slo_ms``.
"""

import argparse
import json
import statistics
import sys

from bench.run import _environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from bench import spec
    from bench.serve import Served
    from repro_torch.perf import autotune

    if not torch.cuda.is_available():
        print("bench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    autotune.configure(enabled=False)
    for name in args.workloads.split(","):
        served = Served(spec.load_cell(name), args.seed, "cuda")
        served.executor.warmup(1, 1)
        ms = [served.executor.mean_latency(1, 1, iters=10) * 1e3
              for _ in range(args.repeats)]
        base = statistics.median(ms)
        print(json.dumps({"workload": name, "bs1_ms": ms, "median_ms": base,
                          "slo_ms": 4 * base,
                          "card": torch.cuda.get_device_name(0)}),
              flush=True)
        served.executor.shutdown()
        del served
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
