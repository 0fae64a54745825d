"""The port's serving loop on a real (TINY) model on the CPU: the torch
counterpart of ``tests/test_system.py::test_real_executor_llm_serving``,
zero bucket-cache misses after warm-up, and ``fits()`` against the
reference's formula for the same bytes."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving.executor import RealExecutor as JaxRealExecutor  # noqa: E402
from repro_torch.core.controller import DNNScalerController  # noqa: E402
from repro_torch.launch.serve import real_executor_for  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.executor import RealExecutor  # noqa: E402


def _tiny_executor():
    return real_executor_for("smollm_360m", tiny=True, device="cpu",
                             prompt_len=32, new_tokens=4)


def test_real_executor_llm_serving():
    """Wall-clock path: serve a tiny real model (prefill + greedy decode
    through the kernel wrappers), DNNScaler stays live."""
    ex, cfg = _tiny_executor()
    assert cfg.kernel_impl == "pallas"
    base = ex.mean_latency(1, 1)
    slo = base * 6
    ctrl = DNNScalerController(ex, slo, m=8, n=4, max_bs=32, max_mtl=4)
    eng = ServingEngine(ex, slo, instance_launch_s=0.05)
    s = eng.run(ctrl, max_steps=60).summary()
    assert s["throughput"] > 0
    a = ctrl.action()
    assert a.bs >= 1 and a.mtl >= 1


def _serve_warm(ex, max_bs=16, max_mtl=2):
    """Warm every bucket up, then serve under the hybrid controller: no
    bucket may be missed after warm-up."""
    buckets = sorted({ex.bucket(n) for n in range(1, max_bs * max_mtl + 1)})
    for n in buckets:
        assert ex.warmup(n, 1) > 0.0            # warm-up time is reported
    assert ex.cache_stats.misses == len(buckets)
    ex.cache_stats.reset_counters()
    base = ex.mean_latency(1, 1)
    ctrl = DNNScalerController(ex, base * 4, mode="hybrid", m=8, n=2,
                               max_bs=max_bs, max_mtl=max_mtl)
    eng = ServingEngine(ex, base * 4, instance_launch_s=0.05)
    s = eng.run(ctrl, max_steps=40).summary()
    assert ex.cache_stats.misses == 0 and ex.cache_stats.hits > 40
    assert s["compile_stall_s"] == 0.0
    return s


def test_no_bucket_misses_after_warmup():
    ex, _ = _tiny_executor()
    _serve_warm(ex)


def test_mamba2_serves_with_no_bucket_misses_after_warmup(monkeypatch):
    """Mamba2 TINY through ``real_executor_for``: every served batch's
    prefill sends each Mamba block through the SSD-scan kernel wrapper."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    ex, cfg = real_executor_for("mamba2_1p3b", tiny=True, device="cpu",
                                prompt_len=32, new_tokens=4)
    assert cfg.kernel_impl == "pallas" and cfg.arch_type == "ssm"
    calls = []
    real = ssd_ops.ssd_scan
    monkeypatch.setattr(ssd_ops, "ssd_scan",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    s = _serve_warm(ex, max_bs=8)
    assert s["throughput"] > 0
    runs = ex.cache_stats.hits + ex.cache_stats.misses
    assert len(calls) >= cfg.num_layers * runs


def test_generate_is_prefill_then_greedy_decode():
    ex, cfg = _tiny_executor()
    batch = ex.make_batch(3)
    out = api.generate(ex.params, batch, cfg, 4)
    assert out.shape == (3, 5) and out.dtype == torch.int32
    logits, _ = api.prefill(ex.params, batch, cfg, capacity=40)
    assert torch.equal(out[:, 0], logits.argmax(-1).to(torch.int32))


@pytest.mark.parametrize("kv_bytes", [0.0, 4096.0])
def test_fits_matches_reference_formula(kv_bytes):
    cfg_j = jax_config("smollm_360m", tiny=True)
    params_j = jax.jit(japi.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg_j)
    params_t = api.params_from_jax(jax.tree.map(np.asarray, params_j),
                                   device="cpu")

    def make_j(n):
        return {"tokens": jax.numpy.zeros((n, 32), jax.numpy.int32)}

    def make_t(n):
        return {"tokens": torch.zeros((n, 32), dtype=torch.int32)}

    pbytes = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(params_j))
    for mem in (None, pbytes * 1.3 + 2e5, pbytes * 1.3 + 5e6, pbytes * 4):
        ej = JaxRealExecutor(lambda p, b: b, params_j, make_j, mem_bytes=mem,
                             kv_bytes_per_item=kv_bytes)
        et = RealExecutor(lambda p, b: b, params_t, make_t, mem_bytes=mem,
                          kv_bytes_per_item=kv_bytes)
        assert et.param_bytes == ej.param_bytes
        for bs in (1, 3, 8, 33, 100, 700):
            for mtl in (1, 2, 7):
                assert et.fits(bs, mtl) == ej.fits(bs, mtl), (mem, bs, mtl)


@pytest.mark.parametrize("arch", ["internvl2-2b", "whisper-medium"])
def test_serve_cli_serves_the_frontend_models(arch, monkeypatch, capsys,
                                              tmp_path):
    """``serve --arch ... --tiny --real --device cpu`` serves the vision stub
    and the encoder-decoder: the controller settles on knobs inside its
    bounds, throughput is positive and no stale bucket is served."""
    _serve_cli(arch, monkeypatch, capsys, tmp_path)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x22b"])
def test_serve_cli_serves_the_moe_models(arch, monkeypatch, capsys,
                                         tmp_path):
    """The same for the two MoE models (capacity dispatch per routing
    group, every expert run on every step)."""
    _serve_cli(arch, monkeypatch, capsys, tmp_path)


def _serve_cli(arch, monkeypatch, capsys, tmp_path):
    import re
    import sys

    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", arch, "--tiny", "--real", "--device", "cpu",
        "--prompt-len", "32", "--new-tokens", "4", "--max-bs", "16",
        "--steps", "20", "--autotune-cache-dir", str(tmp_path)])
    serve.main()
    out = capsys.readouterr().out
    name = arch + "-tiny"
    steady = re.search(rf"{name} \(real, cpu\): controller=dnnscaler "
                       r"approach=\w+ steady\(bs=(\d+), mtl=(\d+)\)", out)
    assert steady, out
    bs, mtl = map(int, steady.groups())
    assert 1 <= bs <= 16 and 1 <= mtl <= 4
    thr = re.search(r"throughput ([\d.]+)/s", out)
    assert thr and float(thr.group(1)) > 0, out
    assert re.search(r"stale evictions 0 stale hits 0", out), out
