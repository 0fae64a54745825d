"""The port's ``serving/replay.py`` and ``launch/report.py`` are verbatim
copies of the reference's: a churn run and a partition run recorded into a
profile store, once by each package, give equal saved traces, equal
what-if reports, and ``report --replay`` / ``report --store`` print and
write the same markdown."""

import json
import shutil
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.launch import report as ref_report  # noqa: E402
from repro.perf import profile_store as ref_ps  # noqa: E402
from repro.serving import cluster as ref_cl  # noqa: E402
from repro.serving import replay as ref_rp  # noqa: E402
from repro_torch.launch import report as port_report  # noqa: E402
from repro_torch.perf import profile_store as port_ps  # noqa: E402
from repro_torch.serving import cluster as port_cl  # noqa: E402
from repro_torch.serving import replay as port_rp  # noqa: E402

REF = dict(cl=ref_cl, rp=ref_rp, ps=ref_ps, report=ref_report)
PORT = dict(cl=port_cl, rp=port_rp, ps=port_ps, report=port_report)


def _record(pkg, runner, root):
    """Record one run into a fresh store at ``root``; return its report.
    The churn run (surface policy) also persists its surface rows there,
    so ``report --store`` has rows to tabulate."""
    store = pkg["ps"].ProfileStore(str(root))
    if runner == "churn":
        return pkg["cl"].run_churn_cluster(
            "surface", n_devices=3, horizon_s=25.0, seed=2,
            profile_store=store, record="run", record_store=store)
    return pkg["cl"].run_partition_cluster(
        "het", n_devices=3, horizon_s=25.0, seed=1, record="run",
        record_store=store)


def _report_main(pkg, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["report"] + argv)
    pkg["report"].main()
    return capsys.readouterr().out


def _everything(pkg, runner, root, monkeypatch, capsys):
    if root.exists():
        shutil.rmtree(root)
    rep = _record(pkg, runner, root)
    trace = json.loads(json.dumps(pkg["rp"].load_trace(
        pkg["ps"].ProfileStore(str(root)), "run")))
    replayed = pkg["rp"].replay_run(trace)
    rows = pkg["rp"].replay_diff(trace, policies=("baseline",
                                                  "fewer-devices", "mig"))
    printed = _report_main(pkg, ["--replay", "run", "--store", str(root)],
                           monkeypatch, capsys)
    out = root.parent / "tables.md"
    _report_main(pkg, ["--store", str(root), "--out", str(out),
                       "--baseline", str(root / "none"),
                       "--final", str(root / "none")],
                 monkeypatch, capsys)
    return dict(rep=rep, trace=trace, replayed=replayed, rows=rows,
                table=pkg["rp"].diff_table(rows), printed=printed,
                markdown=out.read_text())


@pytest.mark.parametrize("runner", ["churn", "partition"])
def test_recorded_trace_and_replay_equal(runner, tmp_path, monkeypatch,
                                         capsys):
    root = tmp_path / "store"
    ref = _everything(REF, runner, root, monkeypatch, capsys)
    port = _everything(PORT, runner, root, monkeypatch, capsys)
    np.testing.assert_equal(port["rep"], ref["rep"])
    assert port["trace"] == ref["trace"]
    assert port["trace"]["event_count"] > 0
    np.testing.assert_equal(port["rows"], ref["rows"])
    assert port["table"] == ref["table"]
    assert port["printed"] == ref["printed"]
    assert f"replay of 'run' (entry={runner}" in port["printed"]
    assert port["markdown"] == ref["markdown"]
    assert "Cross-run profile store" in port["markdown"]
    np.testing.assert_equal(port["replayed"], ref["replayed"])
    if runner == "partition":
        # a run recorded without a warm-start store replays to itself
        np.testing.assert_equal(port["replayed"], port["rep"])
        assert port["rows"][1]["goodput_vs_recorded"] == 1.0
    else:
        assert "| surface row |" in port["markdown"]
