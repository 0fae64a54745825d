"""The port's ``serving/disagg.py`` is a verbatim copy of the reference's:
the cases of ``tests/test_disagg.py`` that need no cluster (the KV-transfer
fabric, the prefill pool's routing and energy, fleet placement, the
disaggregated engine's conservation with a bounded queue and a
mid-transfer revocation, chunked prefill, the controller's pool axis),
run through both packages on the same seeds, give equal results,
exactly."""

import dataclasses

import pytest

pytest.importorskip("jax")

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.serving import device_model as ref_dm  # noqa: E402
from repro.serving import disagg as ref_dg  # noqa: E402
from repro.serving import token_engine as ref_te  # noqa: E402
from repro.serving import workload as ref_wl  # noqa: E402
from repro_torch.configs.base import get_config as port_config  # noqa: E402
from repro_torch.serving import device_model as port_dm  # noqa: E402
from repro_torch.serving import disagg as port_dg  # noqa: E402
from repro_torch.serving import token_engine as port_te  # noqa: E402
from repro_torch.serving import workload as port_wl  # noqa: E402

REF = dict(cfg=ref_config, dm=ref_dm, dg=ref_dg, te=ref_te, wl=ref_wl)
PORT = dict(cfg=port_config, dm=port_dm, dg=port_dg, te=port_te,
            wl=port_wl)


def _plain(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.asdict(x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _equal(fn):
    port, ref = _plain(fn(PORT)), _plain(fn(REF))
    assert port == ref
    return port


def _prof(m, budget=1024):
    return m["dm"].llm_profile(m["cfg"]("gemma2-2b"), mode="decode",
                               kv_seq_budget=budget)


def _trace(m, n, rate, prefill_mean=512):
    return m["te"].ragged_decode_trace(n, 0, rate_rps=rate,
                                       prefill_mean=prefill_mean)


@pytest.mark.parametrize("budget", [1024, 4096])
def test_fabric_prices_kv_handoff_alike(budget):
    def fab(m):
        f = m["dg"].fabric_for(_prof(m, budget), kv_seq_budget=budget)
        times = [f.transfer_s(t) for t in (1, 512, 1024, 4096)]
        charged = [f.charge(t) for t in (100, 2000)]
        return f, times, charged
    _equal(fab)


def test_pool_routes_and_prices_alike():
    def pool(m):
        p = m["dg"].PrefillPool(_prof(m), n_members=2, kv_seq_budget=1024,
                                seed=0)
        got = [p.assign(0.0, 2048), p.assign(0.0, 2048),
               p.assign(0.0, 512), p.assign(100.0, 2048),
               p.assign(200.0, 256)]
        p.kill(1)
        got.append(p.assign(300.0, 64))
        return got, p.stats(), p.energy_j(10.0)
    _equal(pool)


def test_place_disagg_fleet_tail_convention():
    fleet = [f"dev{i}" for i in range(5)]
    for k in (1, 2, 4):
        assert port_dg.place_disagg_fleet(fleet, k) == \
            ref_dg.place_disagg_fleet(fleet, k)
    for dg in (port_dg, ref_dg):
        with pytest.raises(ValueError):
            dg.place_disagg_fleet(fleet, 5)


@pytest.mark.parametrize("case", [
    dict(n=60, rate=40.0, kw=dict(n_prefill=2)),
    dict(n=80, rate=500.0, kw=dict(n_prefill=1, max_slots=4, max_queue=4)),
    dict(n=60, rate=100.0, prefill_mean=2048,
         kw=dict(n_prefill=2, revoke=(0.3, 1))),
], ids=["conserves", "bounded_queue", "revocation"])
def test_disagg_serving_equal(case):
    rep = _equal(lambda m: m["dg"].run_disagg_serving(
        _prof(m), seed=0, trace=_trace(m, case["n"], case["rate"],
                                       case.get("prefill_mean", 512)),
        kv_seq_budget=1024, **case["kw"]))
    assert rep["conserved"]


def test_disagg_cluster_aggregates_equal():
    rep = _equal(lambda m: m["dg"].run_disagg_cluster(
        [_prof(m), _prof(m, 2048)], seed=0, n_requests=40, rate_rps=40.0,
        prefill_mean=512, n_prefill=2, kv_seq_budget=1024))
    assert rep["conserved"] and rep["n_jobs"] == 2


def test_chunked_against_cotenant_on_long_prompts_equal():
    def run(m):
        prof = _prof(m, 4096)
        trace = m["wl"].long_prefill_trace(60, 0, rate_rps=4.0,
                                           prefill_mean=2048)
        slo = 0.9 * prof.prefill_ms / 1e3
        return {mode: m["te"].run_token_serving(
                    prof, policy="continuous", seed=0, trace=trace,
                    prefill_mode=mode, chunk_tokens=512, ttft_slo_s=slo,
                    tpot_slo_s=0.05)
                for mode in ("chunked", "cotenant")}
    reps = _equal(run)
    assert reps["cotenant"]["ttft_attainment"] == 0.0
    assert reps["chunked"]["ttft_attainment"] >= 0.9


def test_controller_pool_axis_equal():
    def run(m):
        return m["dg"].run_disagg_serving(
            _prof(m, 2048), seed=0,
            trace=m["wl"].long_prefill_trace(80, 0, rate_rps=12.0,
                                             prefill_mean=2048),
            n_prefill=3, kv_seq_budget=2048, max_slots=16, ttft_slo_s=1.2,
            tpot_slo_s=0.05, use_controller=True, pool_ladder=(1, 2, 3))
    rep = _equal(run)
    assert rep["conserved"] and 1 <= rep["pool"]["active"] <= 3
