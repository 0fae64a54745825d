"""Serving launcher: serve an assigned architecture on the device under a
controller and report the approach, steady knobs, throughput and p95.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --real
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --real
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
        --tiny --real --device cpu --prompt-len 32 --new-tokens 4

Counterpart of ``repro.launch.serve``'s ``--arch ... --real`` path.  A
served request is a prompt prefill plus greedy decode steps (the reference
served ``train_loss`` here, which reaches no kernel); the model runs with
``kernel_impl="pallas"``, which in this package means the Hopper kernels
on a CUDA device (attention for the dense models and Zamba2's shared block,
the SSD scan for every Mamba block's prefill) and their plain versions on
the CPU.  The paper-job, cluster, churn, token-engine and partition modes
are not ported yet.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import InputShape, get_config
from repro_torch.core.controller import (ClipperController, DNNScalerController,
                                         StaticController)
from repro_torch.models import api
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.executor import RealExecutor


def make_controller(name: str, executor, slo_s: float, bs: int = 1,
                    mtl: int = 1, **kw):
    """kw goes to DNNScalerController (m, n, max_bs, max_mtl, ...).  The
    reference seeds matrix completion with the paper's job library; that
    library is not ported yet, so the estimator starts empty."""
    if name in ("dnnscaler", "hybrid"):
        mode = "hybrid" if name == "hybrid" else "auto"
        return DNNScalerController(executor, slo_s, mode=mode, **kw)
    if name == "clipper":
        return ClipperController(slo_s)
    return StaticController(bs=bs, mtl=mtl)


def real_executor_for(arch: str, tiny: bool = False, *, device=None,
                      prompt_len: int = 512, new_tokens: int = 32,
                      seed: int = 0) -> tuple:
    """(RealExecutor, cfg): random weights from ``seed``, each request a
    ``prompt_len``-token prefill plus ``new_tokens`` greedy decode steps."""
    dev = resolve_device(device)
    cfg = get_config(arch, tiny=tiny).replace(kernel_impl="pallas")
    params = api.init_params(cfg, seed=seed, device=dev)

    def serve_fn(params, batch):
        return api.generate(params, batch, cfg, new_tokens)

    def make_batch(n):
        shp = InputShape("serve", prompt_len, n, "prefill")
        return api.make_batch(cfg, shp, seed=seed + 1, device=dev)

    return RealExecutor(serve_fn, params, make_batch), cfg


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help="assigned architecture id")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--real", action="store_true",
                    help="wall-clock executor (the only mode ported so far)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--controller", default="hybrid",
                    choices=["dnnscaler", "hybrid", "clipper", "static"])
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--max-bs", type=int, default=64)
    ap.add_argument("--max-mtl", type=int, default=4)
    ap.add_argument("--bs", type=int, default=1)
    ap.add_argument("--mtl", type=int, default=1)
    ap.add_argument("--slo-ms", type=float, default=None)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not args.real:
        ap.error("only --real is ported to repro_torch so far")
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    executor, cfg = real_executor_for(
        args.arch, args.tiny, device=args.device, prompt_len=args.prompt_len,
        new_tokens=args.new_tokens, seed=args.seed)
    base = executor.mean_latency(1, 1)
    slo = args.slo_ms / 1e3 if args.slo_ms else base * 4
    ctrl = make_controller(args.controller, executor, slo, args.bs, args.mtl,
                           m=8, n=4, max_bs=args.max_bs, max_mtl=args.max_mtl)
    engine = ServingEngine(executor, slo, instance_launch_s=0.2)
    acc = engine.run(ctrl, max_steps=args.steps)
    s = acc.summary()
    act = ctrl.action()
    approach = getattr(ctrl, "approach", args.controller)
    label = f"{cfg.name} (real, {executor.device.type})"
    print(f"{label}: controller={args.controller} approach={approach} "
          f"steady(bs={act.bs}, mtl={act.mtl})")
    print(f"  throughput {s['throughput']:.1f}/s  p95 {s['p95_s']*1e3:.1f}ms "
          f"(SLO {slo*1e3:.1f}ms)  attainment {s['slo_attainment']:.3f}")
    cs = executor.cache_stats
    print(f"  exec-cache hits {cs.hits} misses {cs.misses} "
          f"(hit rate {cs.hit_rate:.2f})  warm-up "
          f"{cs.compile_time_s:.2f}s charged {s['compile_stall_s']:.2f}s")
    if hasattr(ctrl, "probe_count"):
        print(f"  probes: {ctrl.probe_count} distinct (bs, mtl) points")


if __name__ == "__main__":
    main()
