"""The port's copies of the numpy-only layers (``core/*`` and
``serving/{engine,metrics,device_model,tenancy}``, plus ``SimExecutor``)
are bit-identical to the reference: the ``tests/test_system.py`` scenarios,
driven through both packages with the same seeds, give equal traces and
summaries."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import controller as j_ctrl  # noqa: E402
from repro.core.matrix_completion import \
    LatencyEstimator as JEstimator  # noqa: E402
from repro.serving import device_model as j_dm  # noqa: E402
from repro.serving import tenancy as j_ten  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.serving.executor import SimExecutor as JSim  # noqa: E402
from repro.serving.workload import PAPER_JOBS  # noqa: E402
from repro_torch.core import controller as t_ctrl  # noqa: E402
from repro_torch.core.matrix_completion import \
    LatencyEstimator as TEstimator  # noqa: E402
from repro_torch.serving import device_model as t_dm  # noqa: E402
from repro_torch.serving import tenancy as t_ten  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402
from repro_torch.serving.executor import SimExecutor as TSim  # noqa: E402

REF = dict(ctrl=j_ctrl, Estimator=JEstimator, dm=j_dm, Engine=JEngine,
           Sim=JSim)
PORT = dict(ctrl=t_ctrl, Estimator=TEstimator, dm=t_dm, Engine=TEngine,
            Sim=TSim)


def _run(pkg, job_idx, controller, mode, steps, seeds):
    dm = pkg["dm"]
    job = PAPER_JOBS[job_idx]
    prof = dm.JobProfile(**dataclasses.asdict(job.profile()))
    est = pkg["Estimator"](max_mtl=10)
    for j in PAPER_JOBS[:8]:
        p = dm.JobProfile(**dataclasses.asdict(j.profile()))
        est.add_library_row({m: dm.mt_latency(dm.TESLA_P40, p, 1, m)
                             for m in range(1, 11)})
    if controller == "clipper":
        ctrl = pkg["ctrl"].ClipperController(job.slo_s)
    else:
        ctrl = pkg["ctrl"].DNNScalerController(
            pkg["Sim"](prof, seed=seeds[0]), job.slo_s, estimator=est,
            mode=mode)
    eng = pkg["Engine"](pkg["Sim"](prof, seed=seeds[1]), job.slo_s)
    acc = eng.run(ctrl, max_steps=steps)
    act = ctrl.action()
    return (acc.trace, acc.summary(), (act.bs, act.mtl),
            getattr(ctrl, "approach", None))


# (job index, controller, mode, steps, seeds): the test_system.py scenarios
CASES = [
    (18, "dnnscaler", "auto", 1500, (3, 4)),    # MT job
    (18, "clipper", None, 1500, (0, 5)),        # its Clipper baseline
    (2, "dnnscaler", "auto", 600, (0, 1)),      # B job, binary search
    (3, "dnnscaler", "auto", 1500, (0, 1)),     # power-efficiency job
    (3, "dnnscaler", "hybrid", 600, (0, 1)),    # beyond-paper HybridScaler
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_serving_loop_bit_identical(case):
    ref = _run(REF, *case)
    port = _run(PORT, *case)
    assert port[2:] == ref[2:]
    assert port[0] == ref[0]                    # every (t, knob, p95, thr)
    np.testing.assert_equal(port[1], ref[1])    # summary, NaN-aware


def test_device_model_and_tenancy_bit_identical():
    prof_j = j_dm.paper_profile("resnet_v2_152", "imagenet")
    prof_t = t_dm.JobProfile(**dataclasses.asdict(prof_j))
    bs, mtl = np.arange(1, 65), np.arange(1, 11)
    np.testing.assert_array_equal(
        t_dm.mt_latency_grid(t_dm.TESLA_P40, prof_t, bs, mtl),
        j_dm.mt_latency_grid(j_dm.TESLA_P40, prof_j, bs, mtl))
    for m in range(1, 9):
        pj, pt = j_ten.plan_at_least((16, 16), m), t_ten.plan_at_least((16, 16), m)
        assert dataclasses.asdict(pt) == dataclasses.asdict(pj)
