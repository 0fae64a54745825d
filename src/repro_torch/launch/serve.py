"""Serving launcher: serve an assigned architecture on the device under a
controller and report the approach, steady knobs, throughput and p95.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --real
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --real --autotune --profile-store .profile_store
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
        --tiny --real --device cpu --prompt-len 32 --new-tokens 4

Counterpart of ``repro.launch.serve``'s ``--arch ... --real`` path.  A
served request is a prompt prefill plus greedy decode steps (the reference
served ``train_loss`` here, which reaches no kernel); the model runs with
``kernel_impl="pallas"``, which in this package means the Hopper kernels
on a CUDA device (attention for the dense models and Zamba2's shared block,
the SSD scan for every Mamba block's prefill) and their plain versions on
the CPU.  On a CUDA device each batch bucket's request is captured once in
a CUDA graph and replayed (``RealExecutor``'s ``aot``, as the reference
serves one ahead-of-time executable per bucket); on the CPU it runs
eagerly.

``--autotune`` tunes each kernel shape class a wrapper's lookup misses
(``tune_on_miss``) and persists it in the autotune cache; without it the
wrappers read the cache only.  ``--profile-store`` reloads persisted
surface rows of this architecture and device before serving and persists
this run's probing after it; rows are keyed by the autotuner's backend
key, so rows measured on a card never seed a CPU run, nor the reverse.
The paper-job, cluster, churn, token-engine and partition modes are not
ported yet.
"""

from __future__ import annotations

import argparse
import os

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import InputShape, get_config
from repro_torch.core.controller import (ClipperController, DNNScalerController,
                                         StaticController)
from repro_torch.core.matrix_completion import LatencyEstimator, SurfaceLibrary
from repro_torch.models import api
from repro_torch.perf import autotune
from repro_torch.perf.profile_store import ProfileStore
from repro_torch.serving import device_model as dm
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.executor import RealExecutor
from repro_torch.serving.workload import PAPER_JOBS


def build_library(estimator: LatencyEstimator, exclude_id: int) -> None:
    """Seed matrix completion with 'historically profiled' jobs (each MTL
    curve priced in one vectorized mt_latency_grid call)."""
    mtls = list(range(1, 11))
    for j in PAPER_JOBS[:8]:
        if j.job_id == exclude_id:
            continue
        curve = dm.mt_latency_curve(dm.TESLA_P40, j.profile(), 1, mtls)
        estimator.add_library_row(dict(zip(mtls, curve)))


def make_controller(name: str, executor, slo_s: float, job_id: int = -1,
                    bs: int = 1, mtl: int = 1, *, surface_library=None,
                    surface_key=None, **kw):
    """The reference's controllers, DNNScaler's estimator seeded with the
    paper's job library (``build_library``) as the reference seeds it.
    ``kw`` goes to DNNScalerController (m, n, max_bs, max_mtl, ...)."""
    if name in ("dnnscaler", "hybrid"):
        est = LatencyEstimator(max_mtl=10)
        build_library(est, job_id)
        mode = "hybrid" if name == "hybrid" else "auto"
        return DNNScalerController(executor, slo_s, estimator=est, mode=mode,
                                   surface_library=surface_library,
                                   surface_key=surface_key, **kw)
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
    ap.add_argument("--controller", default="dnnscaler",
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
    ap.add_argument("--autotune", action="store_true",
                    help="tune kernel knobs on cache miss (fills the "
                         "persistent autotune cache; otherwise cache-only)")
    ap.add_argument("--autotune-cache-dir", default=None, metavar="DIR",
                    help="autotune cache location (default: "
                         "$REPRO_AUTOTUNE_CACHE, $REPRO_PROFILE_STORE, or "
                         "./.profile_store)")
    ap.add_argument("--profile-store", default=None, metavar="DIR",
                    help="cross-run profile store: reload persisted surface "
                         "rows before serving and persist this run's "
                         "probing afterwards")
    args = ap.parse_args()
    if not args.real:
        ap.error("only --real is ported to repro_torch so far")

    autotune.configure(cache_dir=args.autotune_cache_dir,
                       tune_on_miss=args.autotune or None)
    store = None
    if args.profile_store is not None:
        store = ProfileStore(args.profile_store)
        if args.autotune_cache_dir is None and \
                not os.environ.get("REPRO_AUTOTUNE_CACHE"):
            # one store for both: the tuned-knob generation that gates the
            # persisted surface rows must come from the document they are in
            autotune.configure(cache_dir=args.profile_store)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    executor, cfg = real_executor_for(
        args.arch, args.tiny, device=args.device, prompt_len=args.prompt_len,
        new_tokens=args.new_tokens, seed=args.seed)
    base = executor.mean_latency(1, 1)
    slo = args.slo_ms / 1e3 if args.slo_ms else base * 4
    lib = surface_key = None
    device_class = autotune.backend_key(executor.device)
    if store is not None and args.controller in ("dnnscaler", "hybrid"):
        # cross-run warm start: earlier runs of this architecture on this
        # device seed the scaler through the persisted shared surface
        lib = SurfaceLibrary()
        surface_key = f"{cfg.name}/serve"
        res = store.load_surfaces(lib, device_class=device_class,
                                  autotune_generation=autotune.generation())
        print(f"profile store: {len(res['loaded'])} surface rows loaded, "
              f"{len(res['evicted'])} evicted")
    ctrl = make_controller(args.controller, executor, slo, bs=args.bs,
                           mtl=args.mtl, surface_library=lib,
                           surface_key=surface_key, m=8, n=4,
                           max_bs=args.max_bs, max_mtl=args.max_mtl)
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
          f"(hit rate {cs.hit_rate:.2f}) stale evictions "
          f"{cs.stale_evictions} stale hits {cs.stale_hits}  warm-up "
          f"{cs.compile_time_s:.2f}s charged {s['compile_stall_s']:.2f}s")
    if executor.captures:
        print(f"  CUDA graphs: {executor.captures} buckets captured, "
              f"{executor.capture_time_s:.2f}s of the warm-up in captures; "
              f"every later step replays its bucket's graph")
    else:
        print("  no CUDA graphs: every step runs eagerly")
    if hasattr(ctrl, "probe_count"):
        print(f"  probes: {ctrl.probe_count} distinct (bs, mtl) points")
    if args.autotune:
        st = autotune.cache_stats()
        print(f"  autotune: {st['tunes']} shape classes tuned on miss, "
              f"{st['timings']} candidates timed, generation "
              f"{st['generation']} ({autotune.cache_path()})")
    if store is not None and getattr(ctrl, "surface_library", None) is not None:
        wrote = store.persist_surface(
            ctrl.surface_library, ctrl.surface_key,
            signature=ctrl.surface_key, device_class=device_class,
            autotune_generation=autotune.generation())
        store.save()
        print(f"  profile store: surface row "
              f"{'persisted' if wrote else 'too sparse to persist'} "
              f"({store.path})")


if __name__ == "__main__":
    main()
