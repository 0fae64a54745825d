"""The port's examples (``repro_torch.examples.*``) against the reference's
``examples/*.py`` on the CPU.

The eight host examples (priced on the reference's simulated devices)
print what the reference's print for the same small arguments, byte for
byte but a temporary store's path, and write the same JSON.  ``warm_start``
takes the same probes, bucket compiles, steady point and throughput as
the reference's (its latencies are the analytic device model's with seeded
noise); the throughput is compared net of the compile stalls, the one
part of the clock each package measures on its own host.  ``quickstart``'s
served function on the reference's converted parameters gives the
reference's logits within 1e-4 (float32), and its printed lines have the
reference's formats."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_train_models import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120

HOST_EXAMPLES = {
    "serve_comparison": ["--jobs", "1,3", "--seconds", "30"],
    "sensitivity": [],
    "cluster_serve": ["--seconds", "30", "--devices", "6", "--json"],
    "cluster_churn": ["--seconds", "30", "--json"],
    "partition_serve": ["--seconds", "30", "--json"],
    "scenario_matrix": ["--seconds", "30", "--json"],
    "replay_whatif": ["--seconds", "30"],
    "disagg_serve": ["--requests", "40", "--json"],
}


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}


def _start(cmd):
    return subprocess.Popen(cmd, cwd=ROOT, env=_env(), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _finish(proc) -> str:
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    return out


@pytest.mark.parametrize("name", list(HOST_EXAMPLES))
def test_host_example_prints_what_the_reference_prints(name, tmp_path):
    pytest.importorskip("jax")
    args = HOST_EXAMPLES[name]
    paths = {}
    runs = {}
    for who, cmd in (("ref", [sys.executable, f"examples/{name}.py"]),
                     ("port", [sys.executable, "-m",
                               f"repro_torch.examples.{name}"])):
        a = list(args)
        if a[-1:] == ["--json"]:
            paths[who] = str(tmp_path / f"{who}.json")
            a.append(paths[who])
        runs[who] = _start(cmd + a)
    out = {who: _finish(p) for who, p in runs.items()}
    for who, path in paths.items():
        out[who] = out[who].replace(path, "JSON")
    if name == "replay_whatif":     # a fresh temporary store each run
        out = {who: re.sub(r"replay_store_\w+", "STORE", s)
               for who, s in out.items()}
    assert out["ref"], "the reference printed nothing"
    assert out["port"] == out["ref"]
    if paths:
        assert (json.loads(Path(paths["port"]).read_text())
                == json.loads(Path(paths["ref"]).read_text()))


REF_WARM = r"""
import json, sys
sys.path.insert(0, "examples")
import warm_start
d = sys.argv[1]
runs, accs = [], []
orig = warm_start.ServingEngine.run
def run(self, *a, **k):
    accs.append(orig(self, *a, **k))
    return accs[-1]
warm_start.ServingEngine.run = run
for _ in range(2):
    r = warm_start.serve_once(d)
    runs.append({**r, "items": accs[-1].total_items,
                 "clock": accs[-1].total_time})
json.dump(runs, open(f"{d}/runs.json", "w"))
"""


def _serve_port(store: str, monkeypatch) -> list:
    """The port's cold and warm runs, each with its items and clock."""
    from repro_torch.examples import warm_start
    accs, orig = [], warm_start.ServingEngine.run

    def run(self, *a, **k):
        accs.append(orig(self, *a, **k))
        return accs[-1]
    monkeypatch.setattr(warm_start.ServingEngine, "run", run)
    runs = []
    for _ in range(2):
        r = warm_start.serve_once(store, device="cpu")
        runs.append({**r, "items": accs[-1].total_items,
                     "clock": accs[-1].total_time})
    return runs


def _net_throughput(r: dict) -> float:
    """Items over the clock with the compile stalls taken out: the
    throughput of the same trajectory whatever the stalls cost here."""
    return r["items"] / (r["clock"] - r["compile_stall_s"])


def test_warm_start_matches_reference_and_warm_is_cheaper(tmp_path,
                                                         monkeypatch):
    pytest.importorskip("jax")
    (tmp_path / "ref").mkdir()
    ref = _start([sys.executable, "-c", REF_WARM, str(tmp_path / "ref")])
    port = _serve_port(str(tmp_path / "port"), monkeypatch)
    _finish(ref)
    want = json.loads((tmp_path / "ref" / "runs.json").read_text())
    for got, exp in zip(port, want):
        for k in ("loaded_rows", "probes", "compiles", "items", "slo_ms"):
            assert got[k] == exp[k], k
        assert tuple(got["steady"]) == tuple(exp["steady"])
        assert _net_throughput(got) == pytest.approx(_net_throughput(exp),
                                                     rel=1e-9)
    cold, warm = port
    assert cold["loaded_rows"] == 0 and warm["loaded_rows"] == 1
    assert warm["probes"] < cold["probes"]
    assert warm["compiles"] < cold["compiles"]
    assert cold["compile_stall_s"] > 0 and warm["compile_stall_s"] > 0


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------
def test_quickstart_serve_fn_matches_reference():
    """TINY SmolLM in float32: the port's served function (a prefill at
    capacity 48, its last logits) on the reference's parameters."""
    pytest.importorskip("jax")
    import jax
    from repro.configs.base import get_config as jax_config
    from repro.models import api as japi
    from repro_torch.configs.base import get_config
    from repro_torch.examples import quickstart
    from repro_torch.models import api
    jcfg = jax_config("smollm-360m", tiny=True).replace(dtype="float32")
    cfg = get_config("smollm-360m", tiny=True).replace(dtype="float32")
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, quickstart.SEQ)).astype(np.int32)

    @jax.jit
    def serve_fn(params, batch):
        logits, _ = japi.prefill(params, batch, jcfg,
                                 capacity=quickstart.CAPACITY)
        return logits

    want = np.asarray(serve_fn(jparams, {"tokens": tokens}))
    params = api.params_from_jax(jax.device_get(jparams), device="cpu")
    got = quickstart.serve_fn_for(cfg)(params,
                                       {"tokens": torch.from_numpy(tokens)})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


QUICKSTART_LINES = [
    r"model: \S+ \([\d,]+ params\)",
    r"base latency \d+\.\dms -> SLO \d+\.\dms",
    r"profiler: TI_B=-?\d+% TI_MT=-?\d+% -> (B|MT)",
    r"steady state: bs=\d+ mtl=\d+",
    r"served \d+ requests @ \d+\.\d/s, p95 \d+\.\dms "
    r"\(SLO \d+\.\dms\), attainment \d\.\d\d",
]


def test_quickstart_prints_the_reference_lines(capsys):
    """``main(["--device", "cpu"])`` and the reference's script print the
    same five lines, each of the reference's format, and the same model
    line (the same TINY config)."""
    pytest.importorskip("jax")
    from repro_torch.examples import quickstart
    ref = _start([sys.executable, "examples/quickstart.py"])
    quickstart.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    want = _finish(ref).splitlines()
    for lines in (got, want):
        assert len(lines) == len(QUICKSTART_LINES), lines
        for line, pattern in zip(lines, QUICKSTART_LINES):
            assert re.fullmatch(pattern, line), (line, pattern)
    assert got[0] == want[0]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_quickstart_without_a_gpu_raises():
    from repro_torch.examples import quickstart
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])
