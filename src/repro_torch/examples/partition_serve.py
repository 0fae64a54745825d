"""Spatial partition sharing: heterogeneous MPS/MIG-style slices vs the
uniform multi-tenancy the paper's knob implies.

A mixed small/large-DNN churn trace (two heavy dense nets that need ~3/4
of a device each, plus light mobile/text nets churning in and out) is
served under three policies, all priced by the SAME calibrated spatial
model (uniform 1/k MPS shares reproduce the paper's MTL curves
bit-identically, so the comparison isolates the policy):

  uniform — every co-resident gets the equal 1/k slice and every share
            change is a full kill+relaunch migration round (the
            time-slicing baseline);
  het     — heterogeneous MPS shares: the HybridScaler's third
            coordinate-descent axis requests slices off a discrete
            ladder, the engine mediates grants against device headroom,
            and churn is absorbed by cheap partition RESIZES (contexts
            stay alive) instead of migrations;
  het-mig — the same on the discrete MIG profile grid (hardware
            isolation, shares snapped to legal profiles).

Asserted here (the PR's acceptance bar):
  * heterogeneous-share placement strictly beats uniform MTL aggregate
    goodput on the mixed trace;
  * the het run's churn resize stalls stay strictly below what the very
    same events would have cost as migrations;
  * request conservation holds for every policy.

    PYTHONPATH=src python -m repro_torch.examples.partition_serve
    PYTHONPATH=src python -m repro_torch.examples.partition_serve --devices 2 \
        --seconds 120 --seed 1 --json experiments/partition.json
"""

import argparse
import json
import os

from repro_torch.serving.cluster import PARTITION_POLICIES, run_partition_cluster
from repro_torch.serving.workload import mixed_partition_trace


def print_report(rep, *, verbose=True):
    agg = rep["aggregate"]
    if verbose:
        print(f"{'job':>5} {'dnn/dataset':<26} {'dev':>12} {'share':>6} "
              f"{'bs':>3} {'mtl':>3} {'rsz':>3} {'mig':>3} {'thr/s':>8} "
              f"{'attain':>6}")
        for r in rep["per_job"]:
            share = f"{r['share']:.3f}" if r["share"] is not None else "—"
            print(f"{r['job_id']:>5} {r['dnn']:<26} {r['device']:>12} "
                  f"{share:>6} {r['bs']:>3} {r['mtl']:>3} "
                  f"{r['resizes']:>3} {r['migrations']:>3} "
                  f"{r['throughput']:>8.1f} {r['slo_attainment']:>6.3f}")
    print(f"  => {agg['policy']:>7}: goodput {agg['goodput']:.1f}/s, "
          f"throughput {agg['aggregate_throughput']:.1f}/s, "
          f"{agg['resizes']} resizes ({agg['resize_stall_s']:.2f}s; "
          f"as migrations: {agg['resize_equiv_migration_stall_s']:.1f}s), "
          f"{agg['migrations']} migrations "
          f"({agg['migration_stall_s']:.1f}s)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--controller", default="hybrid",
                    choices=["hybrid", "dnnscaler"])
    ap.add_argument("--json", default=None,
                    help="dump all reports to this JSON file")
    args = ap.parse_args(argv)

    mode = "hybrid" if args.controller == "hybrid" else "auto"
    # one shared trace so every policy serves the identical workload
    trace = mixed_partition_trace(horizon_s=args.seconds, n_light=5,
                                  seed=args.seed)
    heavy = sum(1 for e in trace if e.job.job_id < 2100)
    print(f"mixed trace: {len(trace)} tenancies ({heavy} heavy, "
          f"{len(trace) - heavy} light churners) over "
          f"{args.seconds:.0f}s on {args.devices} devices")
    print()

    reports = {}
    for policy in PARTITION_POLICIES:
        rep = run_partition_cluster(policy, trace=list(trace), mode=mode,
                                    n_devices=args.devices,
                                    horizon_s=args.seconds, seed=args.seed)
        reports[policy] = rep
        for r in rep["per_job"]:
            assert r["submitted"] == (r["completed"] + r["rejected"]
                                      + r["backlog"]), \
                f"conservation violated for job {r['job_id']} ({policy})"
        assert rep["aggregate"]["conserved"]
        print_report(rep, verbose=(policy != "uniform"))
        print()

    g = {p: reports[p]["aggregate"]["goodput"] for p in PARTITION_POLICIES}
    het = reports["het"]["aggregate"]
    print(f"aggregate goodput: uniform-MTL {g['uniform']:.1f}/s, "
          f"heterogeneous {g['het']:.1f}/s "
          f"(x{g['het'] / max(g['uniform'], 1e-9):.2f}), "
          f"MIG grid {g['het-mig']:.1f}/s")
    ok_goodput = g["het"] > g["uniform"]
    ok_resize = (het["resize_stall_s"]
                 < het["resize_equiv_migration_stall_s"])
    print(f"heterogeneous shares beat uniform MTL: "
          f"{'PASS' if ok_goodput else 'FAIL'}; "
          f"resize stalls ({het['resize_stall_s']:.2f}s) strictly below "
          f"the same events as migrations "
          f"({het['resize_equiv_migration_stall_s']:.1f}s): "
          f"{'PASS' if ok_resize else 'FAIL'}")
    assert ok_goodput and ok_resize

    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(reports, f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
