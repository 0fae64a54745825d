"""The port's dry-run (``repro_torch.launch.dryrun``, ``perf.roofline``,
``perf.op_analysis`` on DTensors) against the reference's compiled steps.

TINY SmolLM, Mixtral and Mamba2 x train, prefill and decode (64
positions, batch 8) on a (4, 2) and a data-only (8, 1) mesh: the
reference compiles each step on 8 host devices on an Auto-axis mesh in a
subprocess; the port runs each as rank 0 of a ``fake`` group in a
subprocess of its own per (mesh, arch).  Per-rank argument bytes are
exact on both meshes (but where the reference's compiled decode drops an
argument it never reads: the position of an attention-free model, 4
bytes) and the analytic model FLOPs equal.  Per-rank FLOPs are held
within 10% on the data-only mesh, where neither partitioner has a choice
to make on a 'model' axis; on (4, 2) DTensor's propagation splits over
'model' some work GSPMD replicates there and replicates some it splits,
so those ratios, and the collective bytes by kind, are printed (run with
``-s``) and recorded, with no bound.

The full-size ``smollm_360m x decode_32k x single`` record (256 fake
ranks) has status OK, the reference's keys, and argument bytes equal to
the sum of local shard bytes under the reference's own specs.

The fast path (``dryrun.analyze_step``: each layer group counted at one
to three layers and grown to its depth, the temp bytes phase by phase)
gives the whole step's op-by-op record key for key, for every kind of
layer group in train, prefill and decode, on a (4, 2) mesh.

The train step's temp bytes are held against the reference's compiled
step: widened TINY Qwen2 and Mixtral layer by layer (the FSDP gather),
and full-width Gemma-2-2B at 2 layers on the production (16, 16) mesh
(the vocab-sharded head and its cross-entropy; about 100 s, the
reference's 256-device compile beside the port's record).
"""

import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("smollm_360m", "mixtral_8x22b", "mamba2_1p3b")
KINDS = ("train", "prefill", "decode")
MESHES = ((4, 2), (8, 1))
TIMEOUT = 300

REF_PROG = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import AxisType
from repro.configs.base import get_config, InputShape
from repro.distributed.sharding import MeshInfo
from repro.launch import steps as steps_lib
from repro.perf import roofline
out = {}
for data, model in ((4, 2), (8, 1)):
    mesh = jax.make_mesh((data, model), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    minfo = MeshInfo(mesh)
    for arch in sys.argv[2].split(","):
        cfg = get_config(arch, tiny=True)
        for kind in ("train", "prefill", "decode"):
            shape = InputShape(kind, 64, 8, kind)
            with mesh:
                fn, specs, _, _ = steps_lib.make_step(cfg, minfo, shape)
                compiled = fn.lower(*specs).compile()
                rl = roofline.analyze(compiled, cfg, shape, 8)
            mem = compiled.memory_analysis()
            out[f"{data}x{model}/{arch}/{kind}"] = {
                "argument_size": mem.argument_size_in_bytes,
                "flops": rl.flops, "model_flops": rl.model_flops,
                "coll_bytes": rl.coll_detail["bytes"]}
json.dump(out, open(sys.argv[1], "w"))
print("REF_OK")
"""


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    pytest.importorskip("jax")
    path = tmp_path_factory.mktemp("dryrun_ref") / "ref.json"
    r = subprocess.run([sys.executable, "-c", REF_PROG, str(path),
                        ",".join(ARCHS)], capture_output=True, text=True,
                       timeout=TIMEOUT, env=_env())
    assert "REF_OK" in r.stdout, r.stdout + r.stderr[-4000:]
    return json.loads(path.read_text())


def _port(data: int, model: int, arch: str) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "port.json"
        r = subprocess.run([sys.executable, __file__, str(data), str(model),
                            arch, str(path)], capture_output=True, text=True,
                           timeout=TIMEOUT, env=_env())
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
        return json.loads(path.read_text())


def _run_port_case(data: int, model: int, arch: str, path: str) -> None:
    """One (mesh, arch): its three steps as rank 0 of a fake group."""
    import torch  # noqa: F401
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.perf import roofline
    torch.set_num_threads(1)
    dryrun.fake_group(data * model)
    minfo = make_host_mesh(data, model)
    cfg = get_config(arch, tiny=True)
    out = {}
    for kind in KINDS:
        shape = InputShape(kind, 64, 8, kind)
        fn, specs, in_sh, _ = steps.make_step(cfg, minfo, shape)
        rl = roofline.analyze(fn, dryrun.laid_out(specs, in_sh, minfo), cfg,
                              shape, data * model)
        out[kind] = {"argument_size": rl.memory["argument_size"],
                     "flops": rl.flops, "model_flops": rl.model_flops,
                     "coll_bytes": rl.coll_detail["bytes"]}
    Path(path).write_text(json.dumps(out))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_tiny_records_against_reference(reference, arch, mesh):
    data, model = mesh
    got = _port(data, model, arch)
    for kind in KINDS:
        want = reference[f"{data}x{model}/{arch}/{kind}"]
        g = got[kind]
        # XLA drops a parameter its program never reads: an attention-free
        # decode's position
        unread = 4 if (kind == "decode" and arch == "mamba2_1p3b") else 0
        assert g["argument_size"] == want["argument_size"] + unread, \
            (kind, g["argument_size"], want["argument_size"])
        assert g["model_flops"] == want["model_flops"], kind
        ratio = g["flops"] / want["flops"]
        coll = {k: (g["coll_bytes"][k], want["coll_bytes"][k])
                for k in g["coll_bytes"]
                if g["coll_bytes"][k] or want["coll_bytes"][k]}
        print(f"[dryrun] {data}x{model} {arch} {kind}: per-rank FLOPs "
              f"{g['flops']:.6g} / reference {want['flops']:.6g} = "
              f"{ratio:.4f}; collective bytes (port, reference) {coll}")
        if model == 1:
            assert abs(ratio - 1.0) <= 0.10, (kind, ratio)


# each kind of layer group, TINY but deep enough that every group grows
# past the fast path's three-layer probes and the probes run fewer layers
# than the whole step: (arch, layers of each group, a train step's batch).
# The dense and Mamba2 train steps take 6 microbatches a rank (batch 48),
# which the fast path probes at 3 and 4; the others 1 (2 for the hybrid).
# Mamba2 at 9 layers, which the FSDP rule does not shard (at 8 it would
# shard the layer axis of its 8-head leaves, and the whole step runs).
GROUP_KINDS = {"dense": ("smollm_360m", (8,), 48),
               "moe": ("mixtral_8x22b", (8,), 8),
               "local_global": ("gemma2_2b", (8,), 8),
               "mamba2": ("mamba2_1p3b", (9,), 48),
               "zamba2_super": ("zamba2_1p2b", (11, 2), 8),
               "encoder_decoder": ("whisper_medium", (5, 14), 8)}


def _fast_and_full_case(arch: str, depths: str, batch: str,
                        path: str) -> None:
    """The fast record and the whole step's op-by-op record of each kind
    (a train step of ``batch`` rows), rank 0 of a (4, 2) fake group; the
    fast one first, so nothing it counts comes from a first call the
    whole step made before it."""
    import torch
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.perf import roofline
    torch.set_num_threads(1)
    dryrun.fake_group(8)
    minfo = make_host_mesh(4, 2)
    cfg = dryrun.at_depths(get_config(arch, tiny=True),
                           tuple(int(d) for d in depths.split(",")))
    runs, analyze = [], roofline.analyze

    def counted(fn, args, c, shape, chips, marks):
        runs.append([*dryrun.group_depths(c), shape.global_batch])
        return analyze(fn, args, c, shape, chips, marks)
    roofline.analyze = counted
    out = {}
    for kind in KINDS:
        shape = InputShape(kind, 64, int(batch) if kind == "train" else 8,
                           kind)
        for fast in (True, False):
            runs.clear()
            rl, *_ = dryrun.analyze_step(cfg, minfo, shape, 8, fast=fast)
            out[f"{kind}/{'fast' if fast else 'full'}"] = {
                **rl.to_dict(), "memory_analysis": rl.memory,
                "depths_run": list(runs)}
    Path(path).write_text(json.dumps(out))


@pytest.fixture(scope="module")
def fast_and_full(tmp_path_factory):
    """Every kind's records, one subprocess a kind, all at once."""
    tmp = tmp_path_factory.mktemp("dryrun_fast")
    procs = {name: subprocess.Popen(
        [sys.executable, __file__, "fast", arch,
         ",".join(map(str, depths)), str(batch), str(tmp / f"{name}.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env()) for name, (arch, depths, batch) in GROUP_KINDS.items()}
    out = {}
    for name, p in procs.items():
        try:
            _, err = p.communicate(timeout=TIMEOUT)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        out[name] = (p.returncode, err,
                     json.loads((tmp / f"{name}.json").read_text())
                     if p.returncode == 0 else None)
    return out


@pytest.mark.parametrize("name", list(GROUP_KINDS))
def test_fast_record_equals_the_whole_step_counted(fast_and_full, name):
    """The fast path (each group counted at 1-3 layers and grown to its
    depth, a train step's microbatches at 3 and 4 and grown to their
    count: ``dryrun.analyze_step``) gives the whole step's op-by-op record
    key for key: FLOPs, device-memory bytes, collective bytes and counts
    by kind, argument / output / alias / temp bytes, in train, prefill and
    decode, on a (4, 2) mesh."""
    rc, err, got = fast_and_full[name]
    assert rc == 0, err[-4000:]
    _, depths, train_batch = GROUP_KINDS[name]
    for kind in KINDS:
        fast, full = got[f"{kind}/fast"], got[f"{kind}/full"]
        batch = train_batch if kind == "train" else 8
        # the fast path ran shallow steps only (a train step of 6
        # microbatches at 3 and 4 of them), the full path the whole step
        assert full.pop("depths_run") == [list(depths) + [batch]], kind
        runs = fast.pop("depths_run")
        assert all(max(r[:-1]) <= 3 for r in runs), (kind, runs)
        assert {r[-1] for r in runs} == ({batch // 2, 2 * batch // 3}
                                         if batch == 48 else {batch}), \
            (kind, runs)
        assert fast == full, (kind, {k: (fast[k], full[k]) for k in fast
                                     if fast[k] != full[k]})
        assert full["memory_analysis"]["temp_size"] is not None, kind


# The train step's temp bytes against the reference's compiled step: TINY
# Qwen2-72B and Mixtral-8x22B widened to d_model 512, d_ff 2048, at 4 and 8
# layers, 64 positions x batch 8 on a (4, 2) mesh.  A step that gathers
# every FSDP shard at once holds a gathered copy, its gradient and the
# accumulator of every layer; one that gathers layer by layer holds one
# gathered layer and each layer's gradient on its shard, as the reference's
# scan does.
TEMP_ARCHS = ("qwen2_72b", "mixtral_8x22b")
TEMP_LAYERS = (4, 8)
TEMP_WIDE = {"d_model": 512, "d_ff": 2048}

REF_TEMP_PROG = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import AxisType
from repro.configs.base import get_config, InputShape
from repro.distributed.sharding import MeshInfo
from repro.launch import steps as steps_lib
wide, out = json.loads(sys.argv[3]), {}
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
shape = InputShape("train", 64, 8, "train")
for arch in sys.argv[2].split(","):
    for n in (4, 8):
        cfg = get_config(arch, tiny=True).replace(num_layers=n, **wide)
        with mesh:
            fn, specs, _, _ = steps_lib.make_train_step(cfg, MeshInfo(mesh),
                                                        shape)
            mem = fn.lower(*specs).compile().memory_analysis()
        out[f"{arch}/{n}"] = {"argument_size": mem.argument_size_in_bytes,
                              "temp_size": mem.temp_size_in_bytes}
json.dump(out, open(sys.argv[1], "w"))
print("REF_OK")
"""


def _temp_case(arch: str, path: str) -> None:
    """``arch``'s widened train step at each of ``TEMP_LAYERS``, rank 0 of
    a (4, 2) fake group: argument and temp bytes."""
    import torch
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.perf import roofline
    torch.set_num_threads(1)
    dryrun.fake_group(8)
    minfo = make_host_mesh(4, 2)
    shape = InputShape("train", 64, 8, "train")
    out = {}
    for n in TEMP_LAYERS:
        cfg = get_config(arch, tiny=True).replace(num_layers=n, **TEMP_WIDE)
        fn, specs, in_sh, _ = steps.make_train_step(cfg, minfo, shape)
        rl = roofline.analyze(fn, dryrun.laid_out(specs, in_sh, minfo), cfg,
                              shape, 8)
        out[str(n)] = {k: rl.memory[k] for k in ("argument_size",
                                                  "temp_size")}
    Path(path).write_text(json.dumps(out))


@pytest.fixture(scope="module")
def train_temps(tmp_path_factory):
    """The reference's and the port's records, all four runs at once."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("dryrun_temp")
    procs = {"ref": subprocess.Popen(
        [sys.executable, "-c", REF_TEMP_PROG, str(tmp / "ref.json"),
         ",".join(TEMP_ARCHS), json.dumps(TEMP_WIDE)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env())}
    for arch in TEMP_ARCHS:
        procs[arch] = subprocess.Popen(
            [sys.executable, __file__, "temp", arch,
             str(tmp / f"{arch}.json")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env())
    done = {}
    for name, p in procs.items():
        try:
            out, err = p.communicate(timeout=TIMEOUT)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        assert p.returncode == 0, (name, out[-2000:] + err[-4000:])
        done[name] = json.loads((tmp / f"{name}.json").read_text())
    return done


@pytest.mark.parametrize("arch", TEMP_ARCHS)
def test_train_temp_grows_as_the_reference_layer_by_layer(train_temps, arch):
    """The sharded train step's temp bytes: at 8 layers within 1.5x the
    reference's compiled step, and its growth from 4 to 8 layers within
    1.5x the reference's.  A step that gathers every FSDP shard at once
    grows by several gathered copies of each layer (3.9x / 6.6x the
    reference's for Qwen2, 5.4x / 7.1x for Mixtral); argument bytes equal
    the reference's."""
    ref, got = train_temps["ref"], train_temps[arch]
    for n in TEMP_LAYERS:
        assert got[str(n)]["argument_size"] \
            == ref[f"{arch}/{n}"]["argument_size"], n
    lo, hi = (got[str(n)]["temp_size"] for n in TEMP_LAYERS)
    rlo, rhi = (ref[f"{arch}/{n}"]["temp_size"] for n in TEMP_LAYERS)
    print(f"[dryrun temp] {arch}: port {lo} / {hi}, reference {rlo} / {rhi}"
          f" bytes at {TEMP_LAYERS} layers: {hi / rhi:.2f}x at "
          f"{TEMP_LAYERS[1]}, growth {(hi - lo) / (rhi - rlo):.2f}x")
    assert hi <= 1.5 * rhi, (hi, rhi, hi / rhi)
    assert hi - lo <= 1.5 * (rhi - rlo), (hi - lo, rhi - rlo,
                                          (hi - lo) / (rhi - rlo))


# The head's cross-entropy: full-width Gemma-2-2B (vocabulary 256,000, a
# tied head, softcap 30) cut to 2 layers, seq 1024 x batch 256 on the
# production (16, 16) mesh, 256 ranks, 8 microbatches of 2 rows a rank.  A
# cross-entropy that makes each chunk's logits whole over the vocabulary
# holds float32 copies of 2 x 512 x 256,000 logits (19.40 GB a rank, 10.7x
# the reference's); the reference keeps them on each rank's vocabulary
# shard.
HEAD_CASE = {"arch": "gemma2_2b", "layers": 2, "seq": 1024, "batch": 256}

REF_HEAD_PROG = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
import jax
from jax.sharding import AxisType
from repro.configs.base import get_config, InputShape
from repro.distributed.sharding import MeshInfo
from repro.launch import steps as steps_lib
case = json.loads(sys.argv[2])
mesh = jax.make_mesh((16, 16), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
cfg = get_config(case["arch"]).replace(num_layers=case["layers"])
shape = InputShape("train_4k", case["seq"], case["batch"], "train")
with mesh:
    fn, specs, _, _ = steps_lib.make_train_step(cfg, MeshInfo(mesh), shape)
    mem = fn.lower(*specs).compile().memory_analysis()
json.dump({"argument_size": mem.argument_size_in_bytes,
           "temp_size": mem.temp_size_in_bytes}, open(sys.argv[1], "w"))
print("REF_OK")
"""


def _head_case(path: str) -> None:
    """``HEAD_CASE``'s train step, rank 0 of a 256-rank fake group on the
    (16, 16) mesh: argument and temp bytes, and the peak of each phase."""
    import torch
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.perf import roofline
    torch.set_num_threads(1)
    dryrun.fake_group(256)
    minfo = make_host_mesh(16, 16)
    c = HEAD_CASE
    cfg = get_config(c["arch"]).replace(num_layers=c["layers"])
    shape = InputShape("train_4k", c["seq"], c["batch"], "train")
    marks = roofline.PhaseMarks()
    fn, specs, in_sh, _ = steps.make_train_step(cfg, minfo, shape,
                                                mark=marks)
    rl = roofline.analyze(fn, dryrun.laid_out(specs, in_sh, minfo), cfg,
                          shape, 256, marks)
    Path(path).write_text(json.dumps({
        "argument_size": rl.memory["argument_size"],
        "temp_size": rl.memory["temp_size"],
        "phases": [[name, peak] for (name, _), peak in rl.phase_peaks]}))


@pytest.fixture(scope="module")
def head_temps(tmp_path_factory):
    """The reference's and the port's ``HEAD_CASE`` records, both at once."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("dryrun_head")
    procs = {"ref": subprocess.Popen(
        [sys.executable, "-c", REF_HEAD_PROG, str(tmp / "ref.json"),
         json.dumps(HEAD_CASE)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env()),
        "port": subprocess.Popen(
            [sys.executable, __file__, "head", str(tmp / "port.json")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env())}
    done = {}
    for name, p in procs.items():
        try:
            out, err = p.communicate(timeout=TIMEOUT)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        assert p.returncode == 0, (name, out[-2000:] + err[-4000:])
        done[name] = json.loads((tmp / f"{name}.json").read_text())
    return done


def test_train_temp_with_a_vocab_sharded_head_within_the_reference(
        head_temps):
    """Full-width Gemma-2-2B's train step at 2 layers (``HEAD_CASE``): temp
    bytes a rank at most 1.5x the reference's compiled step.  Argument
    bytes equal the reference's."""
    ref, got = head_temps["ref"], head_temps["port"]
    top = max(got["phases"], key=lambda p: p[1])
    print(f"[dryrun head] port {got['temp_size'] / 1e9:.2f} GB (peak in "
          f"{top[0]!r}), reference {ref['temp_size'] / 1e9:.2f} GB: "
          f"{got['temp_size'] / ref['temp_size']:.2f}x")
    assert got["argument_size"] == ref["argument_size"]
    assert got["temp_size"] <= 1.5 * ref["temp_size"], (
        got["temp_size"], ref["temp_size"], top)


def _local_bytes(shape, spec, sizes, itemsize) -> int:
    n = math.prod(shape)
    for entry in spec:
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            n //= sizes[a]
    return n * itemsize


def test_full_size_record_has_the_reference_keys_and_exact_arguments():
    """``smollm_360m x decode_32k x single`` through the CLI: status OK,
    the reference's record and roofline keys, and argument bytes equal to
    the local shard bytes of the reference's own specs."""
    jax = pytest.importorskip("jax")
    from jax.sharding import PartitionSpec as P
    from repro.configs.base import INPUT_SHAPES, get_config
    from repro.distributed import sharding as jshd
    from repro.models import api as japi
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "smollm_360m", "--shape", "decode_32k", "--mesh", "single",
             "--out", tmp], capture_output=True, text=True, timeout=TIMEOUT,
            env=_env())
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
        assert "1 OK / 0 SKIP / 0 FAIL" in r.stdout
        rec = json.loads(
            (Path(tmp) / "smollm_360m__decode_32k__single.json").read_text())
    assert rec["status"] == "OK" and rec["chips"] == 256
    assert {"arch", "shape", "mesh", "variant", "chips", "status", "lower_s",
            "compile_s", "memory_analysis", "roofline"} <= rec.keys()
    assert {"argument_size", "output_size", "temp_size", "alias_size",
            "generated_code_size"} <= rec["memory_analysis"].keys()
    assert set(rec["roofline"]) == {
        "flops_per_chip", "hbm_bytes_per_chip", "coll_bytes_per_chip",
        "chips", "model_flops_global", "t_compute", "t_memory",
        "t_collective", "dominant", "useful_flops_ratio", "memory_per_chip",
        "coll_detail", "xla_cost"}

    cfg, shape = get_config("smollm_360m"), INPUT_SHAPES["decode_32k"]
    B, S = shape.global_batch, shape.seq_len
    sizes = {"data": 16, "model": 16}
    minfo = type("M", (), {"axis_sizes": sizes, "model": 16, "data": 16,
                           "has_pod": False, "batch_axes": ("data",),
                           "batch_size": 16})()
    params = japi.param_specs(cfg)
    cache = jax.eval_shape(lambda: japi.init_cache(cfg, B, S))
    want = 0
    for tree, specs in (
            (params, jshd.param_specs(params, cfg, minfo, "infer")),
            (cache, jshd.cache_specs_tree(cache, cfg, minfo, B, S))):
        leaves = jax.tree.leaves(tree)
        spec_leaves = jax.tree.leaves(specs,
                                      is_leaf=lambda x: isinstance(x, P))
        want += sum(_local_bytes(x.shape, s, sizes, x.dtype.itemsize)
                    for x, s in zip(leaves, spec_leaves))
    want += _local_bytes((B,), (jshd.batch_spec_axes(minfo, B),), sizes, 4)
    want += 4                                           # pos, replicated
    assert rec["memory_analysis"]["argument_size"] == want


def test_skip_reasons_equal_reference():
    """``skip_reason`` of every arch x input shape: the reference's string,
    long_500k skipped for the full-attention archs only."""
    pytest.importorskip("jax")
    prog = ("import json, sys\n"
            "from repro.configs.base import ARCH_IDS, INPUT_SHAPES, "
            "get_config\n"
            "from repro.launch.dryrun import skip_reason\n"
            "print(json.dumps({f'{a}/{s}': skip_reason(get_config(a), "
            "INPUT_SHAPES[s]) for a in ARCH_IDS for s in INPUT_SHAPES}))\n")
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=TIMEOUT, env=_env())
    assert r.returncode == 0, r.stderr[-4000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, get_config
    from repro_torch.launch.dryrun import skip_reason
    got = {f"{a}/{s}": skip_reason(get_config(a), INPUT_SHAPES[s])
           for a in ARCH_IDS for s in INPUT_SHAPES}
    assert got == want
    assert sum(v is not None for v in got.values()) >= 1


def test_plain_op_counts_unchanged_by_the_rank_counting():
    """A plain program has no collective, and counts what it counted: the
    TINY decode step's FLOPs equal those of the same step as rank 0 of a
    one-rank mesh, and its op count is the plain one."""
    r = subprocess.run([sys.executable, __file__, "plain"],
                       capture_output=True, text=True, timeout=TIMEOUT,
                       env=_env())
    assert r.returncode == 0, r.stderr[-4000:]
    plain, ranked = json.loads(r.stdout.strip().splitlines()[-1])
    assert plain["total_coll_bytes"] == 0 and not any(
        plain["coll_count"].values())
    assert ranked["flops"] == plain["flops"]
    assert ranked["total_coll_bytes"] == 0


def _plain_case() -> None:
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.perf.op_analysis import analyze_ops
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = get_config("smollm_360m", tiny=True)
    params = api.init_params(cfg, device="meta")
    cache = api.init_cache(cfg, 4, 32, device="meta")
    tok = torch.empty((4,), dtype=torch.int32, device="meta")
    pos = torch.empty((), dtype=torch.int32, device="meta")

    def step(p, c, t, q):
        with implicit_replication():
            return api.decode_step(p, c, t, q, cfg)
    plain = analyze_ops(step, params, cache, tok, pos)
    dryrun.fake_group(1)
    minfo = make_host_mesh(1, 1)
    rep = shd.to_placements((), minfo.mesh)
    lay = lambda tree: shd.tree_map_with_path(  # noqa: E731
        lambda _, t: shd.distribute(t, rep, minfo), tree)
    ranked = analyze_ops(step, lay(params), lay(cache),
                         shd.distribute(tok, rep, minfo),
                         shd.distribute(pos, rep, minfo))
    keep = ("flops", "total_coll_bytes", "coll_count", "n_ops")
    print(json.dumps([{k: plain[k] for k in keep},
                      {k: ranked[k] for k in keep}]))


def _reference_records(arch: str, shape: str, mesh: str, out: str) -> None:
    """The reference's own dry-run records (``repro.launch.dryrun.run_one``,
    512 host devices) on an Auto-axis mesh: its CLI FAILs every record
    under jax 0.9, whose ``jax.make_mesh`` defaults to Explicit axes
    ("The spec of NamedSharding passed to with_sharding_constraint can
    only refer to Auto axes").  ``mesh``: single, multi or both; the
    records land in ``out`` under the port's record names, for
    ``python -m repro_torch.launch.dryrun --report --beside``."""
    from repro.launch import dryrun as ref  # sets the host device count
    import jax
    from jax.sharding import AxisType

    def auto_mesh(*, multi_pod: bool = False):
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        return jax.make_mesh(shape, axes,
                             axis_types=(AxisType.Auto,) * len(axes))
    ref.make_production_mesh = auto_mesh
    for multi in {"single": [False], "multi": [True],
                  "both": [False, True]}[mesh]:
        ref.run_one(arch, shape, multi, out)


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference_records(*sys.argv[2:6])
    elif sys.argv[1] == "plain":
        _plain_case()
    elif sys.argv[1] == "fast":
        _fast_and_full_case(*sys.argv[2:6])
    elif sys.argv[1] == "temp":
        _temp_case(*sys.argv[2:4])
    elif sys.argv[1] == "head":
        _head_case(sys.argv[2])
    else:
        _run_port_case(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                       sys.argv[4])
