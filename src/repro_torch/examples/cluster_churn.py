"""Online job churn on the simulated cluster: jobs arrive and depart
mid-run, and the engine re-places them with explicit migration costs.

Compares three placement policies on one churn trace (Table-4 pool plus
LLM decode jobs, Poisson arrivals at 60% of each job's full-device
SLO-feasible capacity):

  union    — static placement over the union of every tenancy that ever
             appears: the over-provisioned baseline, where every share is
             thinned by tenants that are not even there yet (or already
             left);
  dynamic  — online admission/draining: incremental SLO-aware packing that
             anticipates each job's predicted hybrid steady state,
             migration-aware relocation when direct placement leaves a job
             underserved, and drain-time rebalancing — every share change
             pays an instance kill+relaunch stall (plus checkpoint
             transfer on TPU submesh moves);
  surface  — dynamic plus the cross-job shared latency surface: probed
             (bs, mtl) points pool into a jobs x knobs matrix completed by
             soft-impute, and a newly admitted job with architecturally
             similar history seeds (and starts) its HybridScaler from the
             completed row instead of climbing from the analytic floor.

Request conservation — submitted == completed + rejected + backlog, per
job — is asserted for every policy.

    PYTHONPATH=src python -m repro_torch.examples.cluster_churn
    PYTHONPATH=src python -m repro_torch.examples.cluster_churn --devices 5 \
        --seconds 150 --seed 2 --json experiments/churn.json
"""

import argparse
import json
import os

from repro_torch.serving.cluster import CHURN_POLICIES, run_churn_cluster
from repro_torch.serving.workload import churn_trace


def print_report(rep, *, verbose=True):
    agg = rep["aggregate"]
    if verbose:
        print(f"{'job':>4} {'dnn/dataset':<26} {'dev':>12} {'life':>13} "
              f"{'bs':>3} {'mtl':>3} {'thr/s':>8} {'mig':>3} {'sub':>7} "
              f"{'comp':>7} {'rej':>6} {'attain':>6}")
        for r in rep["per_job"]:
            end = r["drained_at"] if r["drained_at"] is not None else "end"
            life = f"{r['admit_s']:.0f}-" + (
                f"{end:.0f}" if isinstance(end, float) else end)
            print(f"{r['job_id']:>4} {r['dnn']:<26} {r['device']:>12} "
                  f"{life:>13} {r['bs']:>3} {r['mtl']:>3} "
                  f"{r['throughput']:>8.1f} {r['migrations']:>3} "
                  f"{r['submitted']:>7} {r['completed']:>7} "
                  f"{r['rejected']:>6} {r['slo_attainment']:>6.3f}")
    print(f"  => {agg['policy']:>7}: goodput {agg['goodput']:.1f}/s, "
          f"throughput {agg['aggregate_throughput']:.1f}/s, "
          f"{agg['admissions']} admissions / {agg['drains']} drains / "
          f"{agg['migrations']} migrations "
          f"({agg['migration_stall_s']:.1f}s migration stalls)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=5)
    ap.add_argument("--seconds", type=float, default=150.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--controller", default="hybrid",
                    choices=["hybrid", "dnnscaler"])
    ap.add_argument("--json", default=None,
                    help="dump all reports to this JSON file")
    args = ap.parse_args(argv)

    mode = "hybrid" if args.controller == "hybrid" else "auto"
    # one shared trace so every policy serves the identical workload
    trace = churn_trace(horizon_s=args.seconds, seed=args.seed)
    print(f"churn trace: {len(trace)} tenancies over {args.seconds:.0f}s "
          f"on {args.devices} devices "
          f"({sum(1 for e in trace if e.admit_s > 0)} arrive mid-run, "
          f"{sum(1 for e in trace if e.depart_s is not None)} depart)")
    print()

    reports = {}
    for policy in CHURN_POLICIES:
        rep = run_churn_cluster(policy, trace=list(trace), mode=mode,
                                n_devices=args.devices,
                                horizon_s=args.seconds, seed=args.seed)
        reports[policy] = rep
        # request conservation must hold across every reconfiguration
        for r in rep["per_job"]:
            assert r["submitted"] == (r["completed"] + r["rejected"]
                                      + r["backlog"]), \
                f"conservation violated for job {r['job_id']} ({policy})"
        assert rep["aggregate"]["conserved"]
        print_report(rep, verbose=(policy != "union"))
        print()

    g = {p: reports[p]["aggregate"]["goodput"] for p in CHURN_POLICIES}
    print(f"aggregate goodput: static-union {g['union']:.1f}/s, "
          f"dynamic {g['dynamic']:.1f}/s "
          f"(x{g['dynamic'] / max(g['union'], 1e-9):.2f}), "
          f"dynamic+surface {g['surface']:.1f}/s "
          f"(x{g['surface'] / max(g['union'], 1e-9):.2f})")
    ok = g["surface"] > g["union"]
    print(f"dynamic re-placement + shared surface beats static-union "
          f"placement: {'PASS' if ok else 'FAIL'}; request conservation "
          f"held for all {sum(len(r['per_job']) for r in reports.values())} "
          f"job rows: PASS")

    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(reports, f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
