"""Record a churn run, then replay it under counterfactual policies.

The capacity-planning loop the replay planner enables: serve a recorded
production window once (here: the standard churn trace under dynamic
placement), persist its inputs + event stream into the profile store,
then — without re-specifying anything — ask what the SAME workload would
have achieved under different operating decisions:

  baseline       the recorded policy, verbatim.  Replay determinism is
                 asserted: the replayed report equals the recorded run's
                 report EXACTLY (same seeds, same floats), so every
                 counterfactual delta is attributable to the policy
                 change alone, not simulator noise;
  uniform-mtl    uniform multi-tenancy everywhere instead of the hybrid
                 per-job batching/MTL choice (the paper's MT column,
                 forced fleet-wide);
  mig            the same tenancies on a MIG-partitioned fleet: discrete
                 hardware slices, churn handled by partition resizes
                 instead of kill+relaunch migrations;
  fewer-devices  the recorded workload on 80% of the fleet — the
                 "can we hand two machines back?" question.

    PYTHONPATH=src python -m repro_torch.examples.replay_whatif
    PYTHONPATH=src python -m repro_torch.examples.replay_whatif --devices 5 \
        --seconds 100 --store /tmp/replay_store
"""

import argparse
import tempfile

from repro_torch.perf.profile_store import ProfileStore
from repro_torch.serving import replay as rp
from repro_torch.serving.cluster import run_churn_cluster
from repro_torch.serving.workload import churn_trace


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--store", default=None,
                    help="profile store dir (default: a temp dir)")
    args = ap.parse_args(argv)

    root = args.store or tempfile.mkdtemp(prefix="replay_store_")
    store = ProfileStore(root)

    trace = churn_trace(horizon_s=args.seconds, n_initial=3, n_churn=6,
                        seed=args.seed)
    print(f"recording: {len(trace)} tenancies, {args.devices} devices, "
          f"{args.seconds:.0f}s horizon -> store {root}")
    rep = run_churn_cluster("dynamic", trace=trace,
                            n_devices=args.devices,
                            horizon_s=args.seconds, seed=args.seed,
                            record="whatif", record_store=store)
    agg = rep["aggregate"]
    print(f"recorded: goodput {agg['goodput']:.1f}/s, "
          f"throughput {agg['aggregate_throughput']:.1f}/s, "
          f"{agg['migrations']} migrations\n")

    recorded = rp.load_trace(store, "whatif")

    # determinism contract: baseline replay == the recorded run, exactly
    assert rp.replay_run(recorded) == rep, \
        "baseline replay diverged from the recorded run"
    print("baseline replay reproduces the recorded report exactly: PASS\n")

    rows = rp.replay_diff(recorded, profile_store=store)
    print(rp.diff_table(rows))
    by = {r["policy"]: r for r in rows}
    print(f"\nwhat-if: shrinking the fleet to "
          f"{by['fewer-devices']['devices']} devices keeps "
          f"{100 * by['fewer-devices']['goodput_vs_recorded']:.0f}% of "
          f"goodput; forcing uniform MTL keeps "
          f"{100 * by['uniform-mtl']['goodput_vs_recorded']:.0f}%; "
          f"a MIG'd fleet keeps "
          f"{100 * by['mig']['goodput_vs_recorded']:.0f}% with "
          f"{by['mig']['migrations']} migrations")


if __name__ == "__main__":
    main()
