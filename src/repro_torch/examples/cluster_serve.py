"""Cluster-scale serving of the paper's full 30-job Table-4 trace.

Runs the whole workload end-to-end on a simulated fleet under two policies —
the paper's per-job DNNScaler (profile, then commit to Batching OR
Multi-Tenancy) and the joint-knob HybridScaler — and reports per-job SLO
attainment plus aggregate cluster throughput.  With --full it also runs the
pure-B / pure-MT ablations and the Clipper baseline.

    PYTHONPATH=src python -m repro_torch.examples.cluster_serve
    PYTHONPATH=src python -m repro_torch.examples.cluster_serve --devices 12 \
        --seconds 240 --full --json experiments/cluster.json
"""

import argparse
import json
import os

from repro_torch.serving.cluster import run_paper_cluster


def print_report(rep, *, verbose=True):
    agg = rep["aggregate"]
    if verbose:
        print(f"{'job':>3} {'dnn/dataset':<26} {'dev':>12} {'appr':>4} "
              f"{'bs':>3} {'mtl':>3} {'thr/s':>8} {'p95*':>8} {'SLO':>7} "
              f"{'attain':>6} ok")
        for r in rep["per_job"]:
            ok = ("-" if not r["feasible"]
                  else "Y" if r["tail_p95_ms"] <= r["slo_ms"] else "N")
            print(f"{r['job_id']:>3} {r['dnn']:<26} {r['device']:>12} "
                  f"{r['approach']:>4} {r['bs']:>3} {r['mtl']:>3} "
                  f"{r['throughput']:>8.1f} {r['tail_p95_ms']:>7.1f}m "
                  f"{r['slo_ms']:>6.1f}m {r['slo_attainment']:>6.3f} {ok}")
        print("    (* steady-state p95 over the last half of the run; "
              "'-' = SLO infeasible even at bs=1 on its slice)")
    print(f"  => {agg['mode']:>7}: aggregate {agg['aggregate_throughput']:.1f}"
          f" items/s over {agg['devices']} devices, "
          f"{agg['jobs_meeting_slo']}/{agg['feasible_jobs']} feasible jobs "
          f"meet SLO, {agg['total_stall_s']:.1f}s instance stalls")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=12)
    ap.add_argument("--seconds", type=float, default=300.0)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--full", action="store_true",
                    help="also run pure-B / pure-MT / clipper ablations")
    ap.add_argument("--json", default=None,
                    help="dump all reports to this JSON file")
    args = ap.parse_args(argv)

    modes = ["auto", "hybrid"] + (["B", "MT", "clipper"] if args.full else [])
    reports = {}
    for mode in modes:
        rep = run_paper_cluster(mode, n_devices=args.devices,
                                sim_time_limit=args.seconds, seed=args.seed)
        reports[mode] = rep
        print_report(rep, verbose=(mode in ("auto", "hybrid")))
        print()

    thr = {m: reports[m]["aggregate"]["aggregate_throughput"] for m in modes}
    best_pure = max((thr.get("B", 0.0), thr.get("MT", 0.0), thr["auto"]))
    print(f"aggregate throughput: paper DNNScaler {thr['auto']:.1f}/s, "
          f"HybridScaler {thr['hybrid']:.1f}/s "
          f"(x{thr['hybrid'] / max(thr['auto'], 1e-9):.2f})")
    if args.full:
        print(f"pure-B {thr['B']:.1f}/s  pure-MT {thr['MT']:.1f}/s  "
              f"clipper {thr['clipper']:.1f}/s")
    ok_thr = thr["hybrid"] >= 0.99 * best_pure
    ok_slo = (reports["hybrid"]["aggregate"]["jobs_meeting_slo"]
              == reports["hybrid"]["aggregate"]["feasible_jobs"])
    print(f"hybrid >= best pure strategy: {'PASS' if ok_thr else 'FAIL'}; "
          f"SLO compliance (all feasible jobs): "
          f"{'PASS' if ok_slo else 'FAIL'}")

    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(reports, f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
