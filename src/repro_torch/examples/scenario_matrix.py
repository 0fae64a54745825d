"""The scenario matrix: {steady, diurnal, flash-crowd} traffic x
{fixed, spot} capacity x {power-packed, spread} placement, all served by
the MPS partition planner with the HybridScaler's share axis active.

Each cell runs the same six-light-tenant trace shape under one traffic
kind; spot cells additionally revoke one preemptible device mid-run
(residents get a grace window to evacuate).  The comparison the matrix
exists for: `pack` consolidates tenants onto few devices and power-gates
the rest, so it pays the idle floor on ~half the fleet — measurably
fewer joules per good request than `spread` at the SAME goodput and
>= 0.95 SLO attainment in every cell (the BENCH_scenarios gate).

Asserted here (the PR's acceptance bar):
  * every cell conserves requests (submitted == completed + rejected +
    backlog), including through spot revocations;
  * pack's joules-per-good-request beats spread's for every
    (traffic, capacity) pair at equal goodput;
  * spot cells actually fire their revocation.

    PYTHONPATH=src python -m repro_torch.examples.scenario_matrix
    PYTHONPATH=src python -m repro_torch.examples.scenario_matrix \
        --seconds 240 \
        --seed 3 --json experiments/scenarios.json
"""

import argparse
import json
import os

from repro_torch.serving.cluster import SCENARIO_TRAFFICS, run_scenario_cluster


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=150.0)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--controller", default="hybrid",
                    choices=["hybrid", "dnnscaler"])
    ap.add_argument("--vectorized", action="store_true")
    ap.add_argument("--json", default=None,
                    help="dump all cell reports to this JSON file")
    args = ap.parse_args(argv)
    mode = "hybrid" if args.controller == "hybrid" else "auto"

    reports = {}
    print(f"{'cell':<24} {'goodput':>9} {'attain':>7} {'J/good':>8} "
          f"{'devs':>4} {'evac':>4} {'kill':>4}")
    for traffic in SCENARIO_TRAFFICS:
        for spot in (False, True):
            for policy in ("pack", "spread"):
                cell = f"{traffic}/{'spot' if spot else 'fixed'}/{policy}"
                rep = run_scenario_cluster(
                    traffic, spot=spot, power_policy=policy, mode=mode,
                    n_devices=args.devices, horizon_s=args.seconds,
                    seed=args.seed, vectorized=args.vectorized)
                a = rep["aggregate"]
                for r in rep["per_job"]:
                    assert r["submitted"] == (r["completed"] + r["rejected"]
                                              + r["backlog"]), \
                        f"conservation violated for job {r['job_id']} " \
                        f"({cell})"
                assert a["conserved"]
                if spot:
                    assert a["preemptions"] >= 1
                reports[cell] = rep
                jpg = a["joules_per_good_request"]
                print(f"{cell:<24} {a['goodput']:>7.1f}/s "
                      f"{a['min_attainment']:>7.3f} "
                      f"{f'{jpg:.4f}J' if jpg is not None else '—':>8} "
                      f"{a['devices_powered']:>4} "
                      f"{a['preempt_evacuated']:>4} "
                      f"{a['preempt_killed']:>4}")

    print()
    ok = True
    for traffic in SCENARIO_TRAFFICS:
        for cap in ("fixed", "spot"):
            jp = reports[f"{traffic}/{cap}/pack"]["aggregate"]
            js = reports[f"{traffic}/{cap}/spread"]["aggregate"]
            saved = 1.0 - (jp["joules_per_good_request"]
                           / js["joules_per_good_request"])
            cell_ok = saved > 0.0
            ok = ok and cell_ok
            print(f"{traffic}/{cap}: pack saves {saved:.1%} joules per "
                  f"good request vs spread "
                  f"({'PASS' if cell_ok else 'FAIL'})")
    assert ok, "power-packed placement failed to beat spread somewhere"

    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(reports, f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
