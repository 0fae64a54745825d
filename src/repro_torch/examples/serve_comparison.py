"""End-to-end serving example: DNNScaler vs Clipper on a slice of the paper's
30-job workload (calibrated simulator) — a miniature of Fig. 5 / Table 6.

    PYTHONPATH=src python -m repro_torch.examples.serve_comparison \
        [--jobs 1,3,5,19,26]
"""

import argparse

import numpy as np

from repro_torch.core.clipper import ClipperController
from repro_torch.core.controller import DNNScalerController
from repro_torch.core.matrix_completion import LatencyEstimator
from repro_torch.serving import device_model as dm
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.executor import SimExecutor
from repro_torch.serving.workload import PAPER_JOBS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", default="1,3,5,12,19,26")
    ap.add_argument("--seconds", type=float, default=240.0)
    args = ap.parse_args(argv)
    ids = [int(x) for x in args.jobs.split(",")]

    est = LatencyEstimator(max_mtl=10)
    mtls = list(range(1, 11))
    for j in PAPER_JOBS[:8]:
        curve = dm.mt_latency_curve(dm.TESLA_P40, j.profile(), 1, mtls)
        est.add_library_row(dict(zip(mtls, curve)))

    print(f"{'job':>22} {'paper':>5} {'ours':>4} {'knob':>8} "
          f"{'DNNScaler':>10} {'Clipper':>9} {'speedup':>8} {'p95/SLO':>8}")
    ratios = []
    for jid in ids:
        job = PAPER_JOBS[jid - 1]
        prof = job.profile()
        ctrl = DNNScalerController(SimExecutor(prof, seed=jid), job.slo_s,
                                   estimator=est)
        eng = ServingEngine(SimExecutor(prof, seed=jid + 1), job.slo_s)
        acc = eng.run(ctrl, max_steps=6000, sim_time_limit=args.seconds)
        eng2 = ServingEngine(SimExecutor(prof, seed=jid + 2), job.slo_s)
        acc2 = eng2.run(ClipperController(job.slo_s), max_steps=6000,
                        sim_time_limit=args.seconds)
        a = ctrl.action()
        knob = f"BS={a.bs}" if ctrl.approach == "B" else f"MTL={a.mtl}"
        ratio = acc.throughput / max(acc2.throughput, 1e-9)
        ratios.append(ratio)
        print(f"{prof.name:>22} {job.paper_method:>5} {ctrl.approach:>4} "
              f"{knob:>8} {acc.throughput:>8.1f}/s {acc2.throughput:>7.1f}/s "
              f"{ratio:>7.2f}x {acc.p95 / job.slo_s:>7.2f}")
    print(f"\ngeomean speedup: {np.exp(np.mean(np.log(ratios))):.2f}x "
          f"(paper: 218% avg, up to 14x on MT jobs)")


if __name__ == "__main__":
    main()
