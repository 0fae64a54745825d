"""The port's ``launch/serve.py`` modes that price the reference's simulated
devices (a paper job, an LLM decode job as a TPU-submesh tenancy, the
Table-4 fleet, churn, partition and scenario fleets, ``--record``,
``--vectorized`` and ``--train-cost-model``) print what the reference's
print for the same arguments, line for line."""

import shutil
import sys

import pytest

pytest.importorskip("jax")

from benchmarks.costmodel_benches import (_dense_records,  # noqa: E402
                                          _paper_pairs)
from repro.launch import serve as ref_serve  # noqa: E402
from repro.perf import autotune as ref_autotune  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.perf import autotune as port_autotune  # noqa: E402
from repro_torch.perf.profile_store import ProfileStore  # noqa: E402


@pytest.fixture(autouse=True)
def _restore_autotune(monkeypatch):
    """``serve`` points each package's autotune cache at its profile
    store; put both back after each test."""
    for at in (ref_autotune, port_autotune):
        for k, v in list(at._state.items()):
            monkeypatch.setitem(at._state, k, v)


def _both(argv, monkeypatch, capsys, store=None, fill=None):
    """stdout of the reference's ``serve`` then the port's on ``argv``;
    ``store`` (a directory) is emptied, and filled by ``fill``, before
    each, so both packages start from the same store at the same path."""
    out = []
    for serve in (ref_serve, port_serve):
        if store is not None:
            shutil.rmtree(store, ignore_errors=True)
            if fill is not None:
                fill(store)
        monkeypatch.setattr(sys, "argv", ["serve"] + argv)
        serve.main()
        out.append(capsys.readouterr().out)
    assert out[1] == out[0]
    return out[1]


@pytest.mark.parametrize("argv,first", [
    (["--job", "5", "--steps", "300"], "job5 "),
    (["--job", "19", "--controller", "clipper", "--steps", "300"], "job19 "),
    (["--job", "3", "--controller", "hybrid", "--steps", "300"], "job3 "),
    (["--arch", "smollm-360m", "--steps", "200"],
     "smollm-360m (TPU submesh tenancy)"),
    (["--cluster", "--devices", "5", "--seconds", "20"], "cluster[auto]"),
    (["--cluster", "--controller", "hybrid", "--devices", "4", "--seconds",
      "20", "--vectorized"], "cluster[hybrid]"),
    (["--churn", "--devices", "3", "--seconds", "30"], "churn[surface/auto]"),
    (["--churn", "--churn-policy", "union", "--controller", "hybrid",
      "--devices", "3", "--seconds", "30"], "churn[union/hybrid]"),
    (["--partition", "--devices", "3", "--seconds", "30"],
     "partition[het/auto]"),
    (["--scenarios", "--devices", "3", "--seconds", "30"],
     "scenario[steady/fixed/legacy]"),
    (["--scenarios", "--spot", "--power-policy", "pack", "--devices", "3",
      "--seconds", "30"], "scenario[steady/spot/pack]"),
], ids=lambda v: " ".join(v) if isinstance(v, list) else None)
def test_priced_mode_prints_what_the_reference_prints(argv, first,
                                                      monkeypatch, capsys):
    assert _both(argv, monkeypatch, capsys).startswith(first)


def test_priced_modes_default_to_the_references_steps(monkeypatch, capsys):
    """Without ``--steps`` a paper job runs the reference's 500."""
    out = _both(["--job", "5"], monkeypatch, capsys)
    assert "steady(" in out


def test_record_and_profile_store(tmp_path, monkeypatch, capsys):
    store = tmp_path / "store"
    out = _both(["--churn", "--devices", "3", "--seconds", "30",
                 "--profile-store", str(store), "--record", "c1"],
                monkeypatch, capsys, store=store)
    assert f"profile store {store}" in out
    assert "c1" in ProfileStore(str(store)).section("traces")


def _fill_with_table4_rows(root):
    st = ProfileStore(str(root))
    for sk, rec in _dense_records(_paper_pairs()).items():
        st.put("surfaces", sk, rec)
    st.save()


@pytest.mark.parametrize("rows", [True, False], ids=["rows", "empty"])
def test_train_cost_model(rows, tmp_path, monkeypatch, capsys):
    store = tmp_path / "store"
    out = _both(["--train-cost-model", "tesla-p40", "--profile-store",
                 str(store)], monkeypatch, capsys, store=store,
                fill=_fill_with_table4_rows if rows else None)
    if rows:
        assert out.startswith("cost model[tesla-p40]: trained on 29 "
                              "surface rows (29 signatures)")
        assert "tesla-p40" in ProfileStore(str(store)).section("cost_model")
    else:
        assert "NOT trained — 0 surface rows" in out


def test_churn_prices_with_a_trained_cost_model(tmp_path, monkeypatch,
                                                capsys):
    """``--churn`` on a store that holds a tesla-p40 cost model, each
    package training its own with ``--train-cost-model`` first: the fleet
    prices its LLM decode jobs from each package's live features (the
    port's from its op analysis, the reference's from its HLO), and both
    print the same report."""
    store = tmp_path / "store"
    out = []
    for serve in (ref_serve, port_serve):
        shutil.rmtree(store, ignore_errors=True)
        _fill_with_table4_rows(store)
        for argv in (["--train-cost-model", "tesla-p40"],
                     ["--churn", "--devices", "4", "--seconds", "30",
                      "--seed", "2"]):
            monkeypatch.setattr(sys, "argv", ["serve"] + argv + [
                "--profile-store", str(store)])
            serve.main()
        out.append(capsys.readouterr().out)
    assert out[1] == out[0]
    assert "trained on 29 surface rows" in out[1]
    assert "churn[surface/auto]" in out[1]


@pytest.mark.parametrize("argv,msg", [
    (["--job", "5", "--record", "x"], "--record applies to"),
    (["--train-cost-model", "tesla-p40"], "requires --profile-store"),
    (["--cluster", "--controller", "static"], "--controller static"),
    (["--cluster", "--job", "5"], "--job has no effect"),
    (["--churn", "--controller", "clipper"], "--churn supports"),
    (["--partition", "--controller", "static"], "--partition supports"),
    (["--scenarios", "--controller", "clipper"], "--scenarios supports"),
])
def test_argument_errors_match(argv, msg, monkeypatch, capsys):
    errs = []
    for serve in (ref_serve, port_serve):
        monkeypatch.setattr(sys, "argv", ["serve"] + argv)
        with pytest.raises(SystemExit) as exc:
            serve.main()
        assert exc.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1])
    assert errs[1] == errs[0] and msg in errs[1]
