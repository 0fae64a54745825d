"""The check's readings at a cell's own size, many seeds in one process:
the program's widest gap (``bench.check``) on each seed, with
``--control 1`` the control's, the float8 reference's first token at the
same positions, and with ``--fault <name>`` the program's with that fault
of ``bench.faults`` planted in its timed path.

    python3 -m bench.control --workload <name> --seeds 1,2,3 --seconds 8 --control 1
    python3 -m bench.control --workload <name> --seeds 1,2,3 --control 0 --fault cache_unwritten

Set-up once; then for each seed the weights and prompts are drawn into
the same tensors (the captured graphs read them), a fresh controller
probes and serves ``--seconds`` at the cell's load, and the sampled
served tokens go to the reference.  One JSON line per seed.  The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time

from bench.run import _environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from bench import check, faults, spec
    from bench.serve import Served, serve_window
    from repro_torch.perf import autotune

    if not torch.cuda.is_available():
        print("bench.control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    autotune.configure(enabled=False)
    cell = spec.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.fault:
        faults.FAULTS[args.fault](setattr)
    served = Served(cell, seeds[0], "cuda")
    served.warm()
    slo_s = cell.knobs["slo_ms"] / 1e3
    for seed in seeds:
        served.reseed(seed)
        ctrl = served.controller(slo_s)
        win = serve_window(served, ctrl, slo_s, args.seconds)
        picks = check.sample(win.steps, seed, cell.traffic["check_requests"])
        prompt, tokens = check.served(served.timed, picks)
        t0 = time.perf_counter()
        prog = check.gaps(cell.conf, served.weights.params, prompt, tokens,
                          "cuda")
        row = {"workload": args.workload, "seed": seed,
               "fault": args.fault, "program": float(prog.max()),
               "program_median": float(sorted(prog)[len(prog) // 2]),
               "requests": len(picks), "tokens": int(tokens.numel()),
               "buckets": sorted({b for _, _, b in picks}),
               "check_s": time.perf_counter() - t0}
        if args.control:
            ctl = check.gaps(cell.conf, served.weights.params, prompt,
                             tokens, "cuda", control=True)
            row["control"] = float(ctl.max())
            row["control_median"] = float(sorted(ctl)[len(ctl) // 2])
        print(json.dumps(row), flush=True)
        del ctrl, win
    return 0


if __name__ == "__main__":
    sys.exit(main())
