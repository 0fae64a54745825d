"""The port's ``serving/workload.py`` is a bit-identical copy of the
reference's, and the port's ``serve`` seeds DNNScaler's matrix-completion
estimator exactly as the reference's does: the same library rows, and the
tests/test_system.py scenarios driven through each package's
``make_controller`` and ``PAPER_JOBS`` give equal traces."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.launch import serve as ref_serve  # noqa: E402
from repro.serving import workload as ref_wl  # noqa: E402
from repro.serving.engine import ServingEngine as RefEngine  # noqa: E402
from repro.serving.executor import SimExecutor as RefSim  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.serving import workload as port_wl  # noqa: E402
from repro_torch.serving.engine import ServingEngine as PortEngine  # noqa: E402
from repro_torch.serving.executor import SimExecutor as PortSim  # noqa: E402


def test_paper_jobs_and_profiles_equal():
    assert len(port_wl.PAPER_JOBS) == len(ref_wl.PAPER_JOBS) == 30
    for pj, rj in zip(port_wl.PAPER_JOBS, ref_wl.PAPER_JOBS):
        assert dataclasses.asdict(pj) == dataclasses.asdict(rj)
        assert pj.slo_s == rj.slo_s
        assert dataclasses.asdict(pj.profile()) == \
            dataclasses.asdict(rj.profile())


@pytest.mark.parametrize("seed", [0, 7])
def test_churn_trace_equal(seed):
    kw = dict(horizon_s=120.0, n_initial=3, n_churn=6, include_llm=False,
              seed=seed)
    port = port_wl.churn_trace(**kw)
    ref = ref_wl.churn_trace(**kw)
    assert [dataclasses.asdict(c) for c in port] == \
        [dataclasses.asdict(c) for c in ref]


@pytest.mark.parametrize("job_id", [-1, 3, 19])
def test_make_controller_seeds_the_reference_library(job_id):
    job = ref_wl.PAPER_JOBS[2]
    rows = []
    for serve, Sim in ((ref_serve, RefSim), (port_serve, PortSim)):
        ex = Sim(job.profile(), seed=0)
        ctrl = serve.make_controller("hybrid", ex, job.slo_s, job_id)
        rows.append(ctrl.estimator.library)
    assert len(rows[1]) == len(rows[0]) == (8 if job_id == -1 or job_id > 8
                                            else 7)
    for got, want in zip(*rows[::-1]):
        np.testing.assert_array_equal(got, want)


# (job index, controller, steps, seeds): the test_system.py scenarios run
# through make_controller, as `serve --job` runs them
CASES = [
    (18, "dnnscaler", 1500, (3, 4)),
    (2, "dnnscaler", 600, (0, 1)),
    (3, "dnnscaler", 1500, (0, 1)),
    (3, "hybrid", 600, (0, 1)),
]


def _run(serve, wl, Sim, Engine, job_idx, controller, steps, seeds):
    job = wl.PAPER_JOBS[job_idx]
    prof = job.profile()
    ctrl = serve.make_controller(controller, Sim(prof, seed=seeds[0]),
                                 job.slo_s, job.job_id)
    acc = Engine(Sim(prof, seed=seeds[1]), job.slo_s).run(ctrl,
                                                          max_steps=steps)
    act = ctrl.action()
    return acc.trace, acc.summary(), (act.bs, act.mtl), ctrl.approach


@pytest.mark.parametrize("case", CASES, ids=str)
def test_seeded_serving_loop_bit_identical(case):
    ref = _run(ref_serve, ref_wl, RefSim, RefEngine, *case)
    port = _run(port_serve, port_wl, PortSim, PortEngine, *case)
    assert port[2:] == ref[2:]
    assert port[0] == ref[0]
    np.testing.assert_equal(port[1], ref[1])


@pytest.mark.parametrize("seed", [0, 3])
def test_long_prefill_trace_matches_the_reference(seed):
    kw = dict(rate_rps=6.0, prefill_mean=3000, decode_mean=64,
              decode_sigma=1.0)
    port = port_wl.long_prefill_trace(50, seed, **kw)
    ref = ref_wl.long_prefill_trace(50, seed, **kw)
    assert [dataclasses.asdict(r) for r in port] == \
        [dataclasses.asdict(r) for r in ref]
    for wl in (port_wl, ref_wl):
        with pytest.raises(ValueError, match="long-prompt"):
            wl.long_prefill_trace(4, seed, prefill_mean=1024)


class _Parsed(Exception):
    """Raised in place of parsing, carrying the parser ``main`` built."""


def _parser_of(main, monkeypatch):
    """The argparse parser a launcher's ``main`` builds, taken at its
    ``parse_args`` call, before anything is served."""
    import argparse

    def grab(self, *args, **kwargs):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed) as got:
        main()
    return got.value.args[0]


def test_serve_defaults_to_the_reference_controller(monkeypatch):
    """``serve`` with no ``--controller`` runs the paper's loop (the
    Profiler picks Batching or Multi-Tenancy, then one 1-D scaler), as the
    reference's does, and offers the same controllers."""
    ref = _parser_of(ref_serve.main, monkeypatch)
    port = _parser_of(port_serve.main, monkeypatch)
    assert port.get_default("controller") == ref.get_default("controller") \
        == "dnnscaler"
    choices = {p: next(a.choices for a in p._actions
                       if a.dest == "controller") for p in (ref, port)}
    assert choices[port] == choices[ref]


@pytest.mark.parametrize("mode", ["cotenant", "disagg"])
def test_serve_token_engine_prints_what_the_reference_prints(mode, capsys,
                                                              monkeypatch):
    """``serve --token-engine`` prices on ``SimExecutor`` in both packages
    (no card, ``--arch`` defaulting to gemma2-2b) and prints the same
    lines."""
    argv = ["serve", "--token-engine", "--requests", "40", "--prefill-mode",
            mode]
    out = {}
    for name, serve in (("ref", ref_serve), ("port", port_serve)):
        monkeypatch.setattr("sys.argv", argv)
        serve.main()
        out[name] = capsys.readouterr().out
    assert out["port"] == out["ref"]
    assert "token-engine[gemma2-2b]" in out["port"]
