"""The port's ``serving/token_engine.py`` is a verbatim copy of the
reference's: the cases of ``tests/test_token_engine.py`` run through both
packages on the same seeds give equal reports, exactly; and the port's
``run_token_serving``, put through the format strings of
``benchmarks/token_benches.py``, reproduces the ``derived`` strings of the
committed ``BENCH_tokens.json`` byte for byte (all but the paged-kernel
row, which is the JAX kernel's error).  The baseline is read, never
written."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.configs.base import get_config as ref_config  # noqa: E402
from repro.serving import device_model as ref_dm  # noqa: E402
from repro.serving import executor as ref_ex  # noqa: E402
from repro.serving import token_engine as ref_te  # noqa: E402
from repro_torch.configs.base import get_config as port_config  # noqa: E402
from repro_torch.serving import device_model as port_dm  # noqa: E402
from repro_torch.serving import executor as port_ex  # noqa: E402
from repro_torch.serving import token_engine as port_te  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF = dict(cfg=ref_config, dm=ref_dm, ex=ref_ex, te=ref_te)
PORT = dict(cfg=port_config, dm=port_dm, ex=port_ex, te=port_te)
SLO = dict(ttft_slo_s=1.0, tpot_slo_s=0.05)


def _plain(x):
    """A report as plain data: the stamped requests as dicts."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.asdict(x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _prof(m, budget=1024):
    return m["dm"].llm_profile(m["cfg"]("gemma2-2b"), mode="decode",
                               kv_seq_budget=budget)


def _trace(m, n=120, rate=12.0):
    return m["te"].ragged_decode_trace(n, 0, rate_rps=rate)


def _sim(m, seed=0, prof=None):
    return m["ex"].SimExecutor(prof or _prof(m), m["dm"].TPU_V5E, seed=seed)


def _equal(fn):
    port, ref = _plain(fn(PORT)), _plain(fn(REF))
    assert port == ref
    return port


@pytest.mark.parametrize("seed", [0, 5])
def test_trace_equal(seed):
    _equal(lambda m: m["te"].ragged_decode_trace(
        200, seed, rate_rps=30.0, prefill_mean=700, decode_sigma=1.1))


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_conservation(policy):
    rep = _equal(lambda m: m["te"].run_token_serving(
        _prof(m), policy=policy, trace=_trace(m), max_slots=16,
        static_bs=16, **SLO))
    assert rep["conserved"] and rep["completed"] == 120


def test_conservation_with_bounded_queue():
    rep = _equal(lambda m: m["te"].run_continuous(
        _trace(m), _sim(m), max_slots=2, max_queue=3, **SLO))
    assert rep["conserved"] and rep["rejected"] > 0


def test_cluster_conservation_and_aggregation():
    rep = _equal(lambda m: m["te"].run_token_cluster(
        [_prof(m), _prof(m)], trace=_trace(m), max_slots=16, **SLO))
    assert rep["conserved"] and rep["n_jobs"] == 2


@pytest.mark.parametrize("mode", ["cotenant", "timeslice", "chunked"])
def test_prefill_modes(mode):
    rep = _equal(lambda m: m["te"].run_continuous(
        _trace(m), _sim(m), max_slots=16, prefill_mode=mode, **SLO))
    assert rep["conserved"]


def test_static_holds_slots_until_longest_member_drains():
    def run(m):
        te = m["te"]
        trace = [te.TokenRequest(0, 0.0, 256, 1),
                 te.TokenRequest(1, 0.0, 256, 100)]
        return (te.run_static(trace, _sim(m), bs=2, **SLO),
                te.run_continuous(trace, _sim(m), max_slots=2, **SLO))
    stat, cont = _equal(run)
    assert stat["steps"] == 100 and cont["tokens_out"] == 101


def test_controller_slot_cap_respected():
    def run(m):
        ex = _sim(m)
        ctrl = m["te"].build_token_controller(ex, SLO["tpot_slo_s"],
                                              max_slots=8)
        rep = m["te"].run_continuous(_trace(m), ex, max_slots=8,
                                     controller=ctrl, **SLO)
        return rep, ctrl.action().bs
    rep, bs = _equal(run)
    assert rep["mean_live_slots"] <= 8.0 and bs <= 8


def test_memory_slot_cap_charges_kv_bytes():
    def caps(m):
        te, dm = m["te"], m["dm"]
        fat = dataclasses.replace(_prof(m), kv_bytes_per_item=4e9)
        return (te.memory_slot_cap(_sim(m), 4096),
                te.memory_slot_cap(_sim(m, prof=fat), 4096))
    unlimited, capped = _equal(caps)
    assert capped < unlimited


def test_sim_token_step_prices_alike():
    def step(m):
        ex = _sim(m)
        return ([ex.token_step_latency(s, 1, p, x) for s in (1, 8, 16)
                 for p in (0, 2) for x in (0.0, 3.5)],
                [ex.run_token_step(8, 1, prefill_tenants=1)
                 for _ in range(3)])
    _equal(step)


# The format strings of benchmarks/token_benches.py, filled from reports.
def _row(rep):
    return (f"goodput={rep['goodput_tokens_s']:.1f}tok/s,"
            f"ttft_attain={rep['ttft_attainment']:.3f},"
            f"tpot_attain={rep['tpot_attainment']:.3f},"
            f"ttft_p95={rep['ttft_p95_s'] * 1e3:.1f}ms,"
            f"tpot_p95={rep['tpot_p95_s'] * 1e3:.2f}ms,"
            f"conserved={'yes' if rep['conserved'] else 'NO'}"
            + (",truncated=1" if rep["truncated"] else ""))


def _bench_rows(te, dm, get_config) -> dict:
    """benchmarks/token_benches.py's engine rows at its committed operating
    point (300 requests at 12 req/s, 16 slots, TTFT 1 s, TPOT 50 ms)."""
    prof = dm.llm_profile(get_config("gemma2-2b"), mode="decode",
                          kv_seq_budget=1024)
    trace = te.ragged_decode_trace(300, 0, rate_rps=12.0)
    kw = dict(seed=0, trace=trace, max_slots=16, **SLO)
    reps = {pol: te.run_token_serving(prof, policy=pol, static_bs=16, **kw)
            for pol in ("continuous", "static")}
    hyb = te.run_token_serving(prof, policy="continuous",
                               use_controller=True, **kw)
    cont, stat = reps["continuous"], reps["static"]
    raw = cont["goodput_tokens_s"] / max(stat["goodput_tokens_s"], 1e-9)
    return {
        "tokens/continuous/16slots": _row(cont),
        "tokens/static/16slots": _row(stat),
        "tokens/continuous_hybrid/16slots": (
            f"goodput={hyb['goodput_tokens_s']:.1f}tok/s,"
            f"ttft_attain={hyb['ttft_attainment']:.3f},"
            f"tpot_attain={hyb['tpot_attainment']:.3f},"
            f"mean_slots={hyb['mean_live_slots']:.1f}"),
        "tokens/continuous_vs_static": (
            f"speedup={min(raw, 4.0):.2f}x,raw_speedup={raw:.2f}x,"
            f"slo_ok={'yes' if cont['slo_attainment'] >= 0.95 else 'NO'}"),
    }


def test_port_reproduces_committed_tokens_bench():
    rows = {r["name"]: r["derived"] for r in json.loads(
        (ROOT / "BENCH_tokens.json").read_text())["rows"]}
    fresh = _bench_rows(port_te, port_dm, port_config)
    assert set(rows) - set(fresh) == {"tokens/paged_kernel/ragged_8x1024"}
    for name, derived in fresh.items():
        assert derived == rows[name], name
