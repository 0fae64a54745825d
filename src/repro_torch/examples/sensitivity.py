"""SLO-sensitivity demo (paper §4.5, Figs 9-10): change the SLO mid-run and
watch DNNScaler re-adapt its knob — batch size for a Batching job
(Inception-V4), instance count for a Multi-Tenancy job (Inception-V1).

    PYTHONPATH=src python -m repro_torch.examples.sensitivity
"""

from repro_torch.core.controller import DNNScalerController
from repro_torch.core.matrix_completion import LatencyEstimator
from repro_torch.serving import device_model as dm
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.executor import SimExecutor
from repro_torch.serving.workload import PAPER_JOBS


def run_case(job, direction):
    prof = job.profile()
    if direction == "tighten":
        slo_fn = lambda t: job.slo_s if t < 60 else job.slo_s * 0.5
    else:
        slo_fn = lambda t: job.slo_s * 0.5 if t < 60 else job.slo_s

    est = LatencyEstimator(max_mtl=10)
    mtls = list(range(1, 11))
    for j in PAPER_JOBS[:8]:
        curve = dm.mt_latency_curve(dm.TESLA_P40, j.profile(), 1, mtls)
        est.add_library_row(dict(zip(mtls, curve)))
    ctrl = DNNScalerController(SimExecutor(prof, seed=0), slo_fn(0.0),
                               estimator=est)
    eng = ServingEngine(SimExecutor(prof, seed=1), slo_fn(0.0),
                        slo_schedule=slo_fn)
    eng.run(ctrl, max_steps=4000, sim_time_limit=130.0)

    knob_i = 1 if ctrl.approach == "B" else 2
    knob_name = "BS" if ctrl.approach == "B" else "MTL"
    print(f"\n{prof.name} ({ctrl.approach}) — SLO {direction}s at t=60s:")
    last_t = -10.0
    for t, bs, mtl, p95, thr, slo in eng.acc.trace:
        if t - last_t >= 10.0:
            knob = bs if knob_i == 1 else mtl
            print(f"  t={t:6.1f}s  SLO={slo * 1e3:6.0f}ms  {knob_name}={knob:>3} "
                  f"p95={p95 * 1e3:6.1f}ms  thr={thr:7.1f}/s")
            last_t = t


def main(argv=None):
    run_case(PAPER_JOBS[2], "tighten")   # Inception-V4: Batching (Fig 9a)
    run_case(PAPER_JOBS[2], "relax")     # (Fig 9b)
    run_case(PAPER_JOBS[0], "tighten")   # Inception-V1: Multi-Tenancy (Fig 10a)
    run_case(PAPER_JOBS[0], "relax")     # (Fig 10b)


if __name__ == "__main__":
    main()
