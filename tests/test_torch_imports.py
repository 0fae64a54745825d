"""Import hygiene of the port: ``src/repro_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package, the port imports with both blocked,
and its entry points default to the GPU and refuse to run quietly on the
CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_port_imports_with_jax_and_reference_blocked():
    mods = ["repro_torch", "repro_torch.configs.base",
            "repro_torch.models.api", "repro_torch.models.transformer",
            "repro_torch.kernels.flash_attention.ops",
            "repro_torch.kernels.decode_attention.ops",
            "repro_torch.kernels.ssd_scan.ops", "repro_torch.models.mamba",
            "repro_torch.serving.executor", "repro_torch.serving.engine",
            "repro_torch.core.controller", "repro_torch.launch.serve",
            "repro_torch.perf.autotune", "repro_torch.perf.profile_store",
            "repro_torch.perf.roofline", "repro_torch.serving.workload",
            "repro_torch.serving.partition",
            "repro_torch.serving.token_engine",
            "repro_torch.serving.disagg", "repro_torch.serving.sim_state",
            "repro_torch.serving.replay", "repro_torch.serving.cluster",
            "repro_torch.perf.cost_model", "repro_torch.perf.op_analysis",
            "repro_torch.launch.report", "repro_torch.training.adamw",
            "repro_torch.training.data", "repro_torch.training.checkpoint",
            "repro_torch.training.loop", "repro_torch.launch.train",
            "repro_torch.examples.train_100m",
            "repro_torch.examples.quickstart",
            "repro_torch.examples.warm_start",
            "repro_torch.examples.serve_comparison",
            "repro_torch.examples.sensitivity",
            "repro_torch.examples.cluster_serve",
            "repro_torch.examples.cluster_churn",
            "repro_torch.examples.partition_serve",
            "repro_torch.examples.scenario_matrix",
            "repro_torch.examples.replay_whatif",
            "repro_torch.examples.disagg_serve",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.cache_update",
            "repro_torch.launch.mesh", "repro_torch.launch.steps",
            "repro_torch.launch.dryrun"]
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            + "".join(f"import {m}\n" for m in mods)
            + "from repro_torch.configs.base import all_configs\n"
            "assert len(all_configs()) == 10\n"
            # the cost model's live path traces the port's own module
            "from repro_torch.configs.base import get_config\n"
            "from repro_torch.perf import cost_model as cm\n"
            "from repro_torch.serving import device_model as dm\n"
            "cfg = get_config('smollm_360m', tiny=True)\n"
            "assert cm.features_for_served_module(\n"
            "    cfg, 'decode', dm.llm_profile(cfg, 'decode')) is not None\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_the_gpu():
    from repro_torch import resolve_device
    from repro_torch.configs.base import get_config
    from repro_torch.models import api
    cfg = get_config("smollm_360m", tiny=True)
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_params(cfg)
    with pytest.raises(RuntimeError):
        api.init_cache(cfg, 1, 8)
    assert api.init_params(cfg, device="cpu")["embed"].device.type == "cpu"
