"""The port's ``serving/cluster.py`` (with ``sim_state.py``) is a verbatim
copy of the reference's: the paper fleet, churn, partition and scenario
runs, driven through both packages with the same seeds, give equal
reports, exactly; and the port's ``VectorClusterEngine`` equals its
``ClusterEngine`` bit for bit, as ``tests/test_sim_vector.py`` holds the
reference's."""

import numpy as np
import pytest

pytest.importorskip("jax")

from benchmarks.costmodel_benches import (_dense_records,  # noqa: E402
                                          _paper_pairs)
from repro.perf import cost_model as ref_cm  # noqa: E402
from repro.perf.profile_store import ProfileStore as RefStore  # noqa: E402
from repro.serving import cluster as ref_cl  # noqa: E402
from repro.serving import sim_state as ref_ss  # noqa: E402
from repro_torch.perf import cost_model as port_cm  # noqa: E402
from repro_torch.perf.profile_store import \
    ProfileStore as PortStore  # noqa: E402
from repro_torch.serving import cluster as port_cl  # noqa: E402
from repro_torch.serving import sim_state as port_ss  # noqa: E402
from repro_torch.serving.workload import (PAPER_JOBS,  # noqa: E402
                                          churn_trace)


def _equal(port, ref):
    """Equal reports, NaN-aware (an idle job's p95 is NaN in both)."""
    np.testing.assert_equal(port, ref)


@pytest.mark.parametrize("mode", ["auto", "hybrid", "clipper"])
def test_paper_cluster_reports_equal(mode):
    kw = dict(n_devices=5, sim_time_limit=20.0, seed=1)
    _equal(port_cl.run_paper_cluster(mode, **kw),
           ref_cl.run_paper_cluster(mode, **kw))


def test_paper_cluster_at_the_serve_defaults():
    """``serve --cluster``'s defaults: the 30 Table-4 jobs on 12 P40s for
    90 simulated seconds, seed 0."""
    port = port_cl.run_paper_cluster("auto", n_devices=12,
                                     sim_time_limit=90.0, seed=0)
    _equal(port, ref_cl.run_paper_cluster("auto", n_devices=12,
                                          sim_time_limit=90.0, seed=0))
    agg = port["aggregate"]
    assert (agg["jobs"], agg["devices"]) == (30, 12)
    assert agg["jobs_meeting_slo"] == agg["feasible_jobs"] == 29


@pytest.mark.parametrize("policy", ["union", "dynamic", "surface"])
def test_churn_cluster_reports_equal(policy):
    kw = dict(n_devices=4, horizon_s=30.0, seed=2)
    _equal(port_cl.run_churn_cluster(policy, **kw),
           ref_cl.run_churn_cluster(policy, **kw))


def _store_with_a_cost_model(store_cls, cm, root):
    """A profile store holding the 29 Table-4 surface rows and the
    tesla-p40 cost model ``cm`` trains on them."""
    st = store_cls(str(root))
    for sk, rec in _dense_records(_paper_pairs()).items():
        st.put("surfaces", sk, rec)
    cm.save_cost_model(st, cm.train_cost_model(st, "tesla-p40"))
    return st


@pytest.mark.parametrize("seed", [0, 2])
def test_churn_with_a_trained_cost_model_reports_equal(seed, tmp_path):
    """The surface policy loads the store's cost model and prices the
    trace's LLM decode jobs (SmolLM, Gemma-2 or Mamba2) from each
    package's live features: the reports are equal."""
    kw = dict(n_devices=4, horizon_s=30.0, seed=seed)
    port_cm._MODULE_FEATURES.clear()
    port = port_cl.run_churn_cluster("surface", profile_store=(
        _store_with_a_cost_model(PortStore, port_cm, tmp_path / "port")),
        **kw)
    ref = ref_cl.run_churn_cluster("surface", profile_store=(
        _store_with_a_cost_model(RefStore, ref_cm, tmp_path / "ref")), **kw)
    _equal(port, ref)
    assert port["aggregate"]["store_rows_loaded"] > 0
    # every LLM job the trace admitted was priced from live features
    feats = dict(port_cm._MODULE_FEATURES)
    assert feats and all(v is not None for v in feats.values())
    assert {arch for arch, _ in feats} <= {"smollm-360m", "gemma2-2b",
                                           "mamba2-1.3b"}


@pytest.mark.parametrize("policy", ["uniform", "het", "het-mig"])
def test_partition_cluster_reports_equal(policy):
    kw = dict(n_devices=4, horizon_s=30.0, seed=0)
    _equal(port_cl.run_partition_cluster(policy, **kw),
           ref_cl.run_partition_cluster(policy, **kw))


@pytest.mark.parametrize("spot,power", [(False, None), (True, "pack")])
def test_scenario_cluster_reports_equal(spot, power):
    kw = dict(spot=spot, power_policy=power, n_devices=4, horizon_s=25.0,
              seed=3)
    _equal(port_cl.run_scenario_cluster("flash", **kw),
           ref_cl.run_scenario_cluster("flash", **kw))


def test_spot_fleet_equal():
    def facts(fleet):
        return [(s.name, s.mesh_shape, s.device.name, s.device.spot)
                for s in fleet]
    assert facts(port_cl.spot_fleet(5, 2)) == facts(ref_cl.spot_fleet(5, 2))


def test_sim_state_is_the_reference_copy():
    """The structure-of-arrays state answers the engines' fleet queries
    as the reference's does on the same clocks, past a growth of its
    arrays."""
    rng = np.random.default_rng(0)
    clocks = rng.uniform(0.0, 10.0, 9)
    clocks[7] = clocks[3]                       # a tie: lowest index wins
    answers = []
    for ss in (port_ss, ref_ss):
        st = ss.SimState(capacity=4)
        for c in clocks:
            st.add_job(admit_s=float(c))
        st.active[5] = False
        answers.append((len(st), st.frontier(), st.next_event_clock(),
                        [st.min_other_active_clock(i) for i in range(9)],
                        st.depart_s.tolist(), st.clock.tolist()))
    assert answers[0] == answers[1]
    assert answers[0][1] == int(np.argmin(np.where(
        np.arange(9) == 5, np.inf, clocks)))


def test_vector_engine_equals_object_engine_paper():
    jobs = PAPER_JOBS[:12]
    engines = [cls(jobs, port_cl.gpu_fleet(5), seed=0,
                   controller_factory=port_cl.paper_controller_factory(
                       "hybrid"))
               for cls in (port_cl.ClusterEngine,
                           port_cl.VectorClusterEngine)]
    reps = [e.run(sim_time_limit=30.0) for e in engines]
    assert reps[0] == reps[1]
    assert engines[0].event_log == engines[1].event_log
    assert engines[0].steps_run == engines[1].steps_run
    assert len(engines[0].event_log) > 100


@pytest.mark.parametrize("runner", ["churn", "partition"])
def test_vector_engine_equals_object_engine_churn(runner):
    if runner == "churn":
        trace = churn_trace(horizon_s=40.0, n_initial=3, n_churn=4,
                            mean_lifetime_s=15.0, seed=1)
        kw = dict(trace=list(trace), n_devices=3, horizon_s=40.0, seed=1)
        run = lambda v: port_cl.run_churn_cluster("surface", vectorized=v,
                                                  **kw)
    else:
        kw = dict(n_devices=3, horizon_s=30.0, seed=0)
        run = lambda v: port_cl.run_partition_cluster("het", vectorized=v,
                                                      **kw)
    assert run(False) == run(True)
