"""The harness on the CPU: every cell resolves by name, names and units
keep to their characters, nothing the harness loads is JAX or the JAX
package, a run without a card fails, and a whole run at a tiny size comes
out correct, and not correct once the timed path is broken underneath
(the look for a card skipped: ``run_cell`` on the CPU).

The card's own tests (marked ``cuda``) read the check's readings at a
cell's full size, the float8 control's and those of a decode state left
unchanged: ``PYTHONPATH=src python -m pytest -q -m cuda bench/tests``."""

import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from bench import check, counts, faults, spec
from bench.run import run_cell
from bench.spec import BENCH, ROOT
from bench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH_JSON = spec.benchmark()


def test_benchmark_json_keys_and_names():
    b = BENCH_JSON
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names)) == len(names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    cells = {w["name"] for w in b["workloads"]}
    reports = {e["name"]: set(e.get("workloads", cells))
               for e in b["end_to_end"]}
    for m in b["per_layer"]:
        # a per-layer metric moves an end-to-end metric each of its cells
        # reports
        assert set(m["workloads"]) <= reports[m["moves"]], m["name"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    assert reports["setup_s"] == cells


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH_JSON["workloads"]])
def test_each_cell_resolves_its_files_and_metrics_by_name(cell):
    c = spec.load_cell(cell)
    assert c.conf["name"] == c.entry["config"]
    assert c.traffic["prompt_len"] > 0 and c.traffic["new_tokens"] >= 0
    assert c.knobs["slo_ms"] > 0 and c.knobs["check"]["widest_gap_limit"] > 0
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) == 2
    assert {spec.quantity(n, {"setup_s"}) for n in e2e} == {
        "goodput_rps", "setup_s"}
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.metric_reader(m["name"]))
    # what the benchmark counts it counts at the served vocabulary
    assert counts.vocab(c.conf) == c.conf["port"]["vocab_size"]


@pytest.mark.parametrize("name", ["mamba2_1p3b", "smollm_360m"])
def test_config_files_run_the_published_shapes(name):
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    c, p = conf["config"], conf["port"]
    assert conf["reduced"] == []
    if conf["family"] == "mamba2":
        assert (p["num_layers"], p["d_model"], p["ssm_state_size"],
                p["ssm_expand"], p["ssm_head_dim"], p["ssm_conv_width"],
                p["ssm_chunk_size"], p["norm_eps"]) == (
            c["n_layer"], c["d_model"], c["d_state"], c["expand"],
            c["headdim"], c["d_conv"], c["chunk_size"], c["norm_epsilon"])
        assert c["ngroups"] == 1
    else:
        assert (p["num_layers"], p["d_model"], p["num_heads"],
                p["num_kv_heads"], p["d_ff"], p["vocab_size"],
                p["rope_theta"], p["norm_eps"]) == (
            c["num_hidden_layers"], c["hidden_size"],
            c["num_attention_heads"], c["num_key_value_heads"],
            c["intermediate_size"], c["vocab_size"], c["rope_theta"],
            c["rms_norm_eps"])
        assert p["head_dim"] * p["num_heads"] == c["hidden_size"]
    assert p["dtype"] == "bfloat16" and p["kernel_impl"] == "pallas"


def _run(code: str, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, env=env)


def test_nothing_the_harness_loads_is_jax_or_the_jax_package():
    code = ("import sys; sys.path.insert(0, 'src'); "
            "import bench.run, bench.serve, bench.check, bench.context, "
            "bench.calibrate, bench.control, bench.faults, "
            "bench.reference.mamba2, "
            "bench.reference.llama; from bench import spec; "
            "[spec.metric_reader(m['name']) for m in "
            "spec.benchmark()['per_layer']]; "
            "print(bench.run.forbidden_modules())")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "bench.run", "--workload",
         BENCH_JSON["workloads"][0]["name"], "--seed", "3000000019",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "nothing runs on the CPU" in out.stderr


SEED = 2 ** 31 + 11


@pytest.fixture
def on_the_cpu(monkeypatch):
    """The harness without a card: the card's calls made no-ops and no
    kernel built, so ``run_cell`` drives the program's eager path."""
    from repro_torch.kernels import build
    for name, value in (("synchronize", None), ("empty_cache", None),
                        ("max_memory_allocated", 0),
                        ("get_device_name", "cpu")):
        monkeypatch.setattr(torch.cuda, name, lambda *a, v=value: v)
    monkeypatch.setattr(build, "build", lambda *names: None)


def _tiny_run(conf, traffic, limit=0.05):
    return run_cell(tiny.cell(conf, traffic, limit), SEED, 1.0, False,
                    time.perf_counter(), device="cpu")


@pytest.mark.parametrize("conf,traffic", [
    (tiny.MAMBA, tiny.GEN), (tiny.MAMBA, tiny.SCORE),
    (tiny.LLAMA, tiny.GEN), (tiny.LLAMA, tiny.SCORE),
    (tiny.LLAMA_WIDE, tiny.GEN16)])
def test_a_sound_tiny_run_is_correct(on_the_cpu, conf, traffic):
    result, checks, notes = _tiny_run(conf, traffic)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] == notes["requests"] > 0
    assert checks["widest_gap"]["value"] <= checks["widest_gap"]["limit"]
    assert notes["window_s"] >= 1.0


@pytest.mark.parametrize("conf,traffic,fault", [
    (tiny.MAMBA, tiny.GEN, "altered_token"),
    (tiny.MAMBA, tiny.SCORE, "altered_token"),
    (tiny.LLAMA, tiny.GEN, "altered_token"),
    (tiny.LLAMA, tiny.SCORE, "altered_token"),
    (tiny.MAMBA, tiny.GEN, "state_unchanged"),
    (tiny.LLAMA_WIDE, tiny.GEN16, "cache_unwritten")])
def test_a_broken_timed_path_comes_out_not_correct(on_the_cpu, monkeypatch,
                                                   conf, traffic, fault):
    faults.FAULTS[fault](monkeypatch.setattr)
    result, checks, _ = _tiny_run(conf, traffic)
    assert not result["correct"] and result["failed"] > 0
    assert checks["widest_gap"]["value"] > checks["widest_gap"]["limit"]


def test_a_traffic_kind_the_harness_does_not_serve_is_refused(on_the_cpu):
    open_loop = dict(tiny.GEN, kind="open_loop")
    with pytest.raises(ValueError, match="open_loop"):
        _tiny_run(tiny.LLAMA, open_loop)


def test_sample_is_drawn_from_the_seed_and_holds_the_largest_bucket():
    from bench.serve import Step
    steps = [Step(3, 0.0, 1.0, 5, 8, 0), Step(4, 1.0, 2.0, 12, 16, 0),
             Step(5, 2.0, 3.0, 8, 8, 0)]
    a = check.sample(steps, 7, 6)
    assert a == check.sample(steps, 7, 6)
    assert a[0] == (4, 0, 16) and len(set(a)) == 6
    assert all(r < {3: 5, 4: 12, 5: 8}[sid] for sid, r, _ in a)
    assert len(check.sample(steps, 7, 100)) == 25


def test_every_step_serves_its_own_requests():
    from bench.serve import Requests
    req = Requests(2 ** 31 + 5, 16, 100)
    a, b = req.batch(1, 4), req.batch(2, 4)
    assert a.shape == (4, 16) and not torch.equal(a, b)
    assert torch.equal(a, Requests(2 ** 31 + 5, 16, 100).batch(1, 4))
    assert int(a.max()) < 100


@pytest.mark.cuda
def test_control_reads_above_the_limit_at_a_cells_size():
    """On the card: at mamba2_1p3b.gen512's own size, three seeds, the
    program's widest gap under the cell's limit and the float8 control's
    over it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = "mamba2_1p3b.gen512"
    out = subprocess.run(
        [sys.executable, "-m", "bench.control", "--workload", cell,
         "--seeds", "3000000001,3000000002,3000000003", "--seconds", "5"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    limit = spec.load_cell(cell).knobs["check"]["widest_gap_limit"]
    rows = [json.loads(line) for line in out.stdout.splitlines()]
    assert len(rows) == 3
    for r in rows:
        assert r["program"] <= limit < r["control"], r


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", [
    ("mamba2_1p3b.gen512", "state_unchanged"),
    ("smollm_360m.gen512", "cache_unwritten")])
def test_a_decode_state_left_unchanged_reads_above_the_limit(cell, fault):
    """On the card: at a generating cell's own size, three seeds, the
    program with its decode step's state (the recurrent state, the KV
    cache) left as it found it reads a widest gap over the cell's
    limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "-m", "bench.control", "--workload", cell,
         "--seeds", "3000000004,3000000005,3000000006", "--seconds", "5",
         "--control", "0", "--fault", fault],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    limit = spec.load_cell(cell).knobs["check"]["widest_gap_limit"]
    rows = [json.loads(line) for line in out.stdout.splitlines()]
    assert len(rows) == 3
    for r in rows:
        assert r["program"] > limit, r
