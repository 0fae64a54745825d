"""Quickstart: serve a (tiny, real) model under DNNScaler on this host; the
counterpart of the reference's ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Builds a reduced SmolLM, measures real wall-clock latency, lets the Profiler
choose Batching vs Multi-Tenancy, and runs the Scaler loop against an
8x-base latency SLO.  Each batch is ``(n, 32)`` tokens served by one
prefill at capacity 48 (its last-position logits); on the GPU the
``RealExecutor`` captures each batch bucket's prefill in a CUDA graph, and
the prefill's attention runs the flash kernel.  ``run`` takes any config,
so the same path serves a full-width model.
"""

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.core.controller import DNNScalerController
from repro_torch.models import api
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.executor import RealExecutor, tensor_leaves

SEQ, CAPACITY, SEED = 32, 48, 0


def serve_fn_for(cfg):
    """The served function: a prefill of the batch at capacity 48, its
    last-position logits."""
    def serve_fn(params, batch):
        logits, _ = api.prefill(params, batch, cfg, capacity=CAPACITY)
        return logits
    return serve_fn


def batch_maker(cfg, device):
    """``make_batch(n)``: ``(n, 32)`` int32 tokens drawn from a generator
    seeded anew each call, as the reference draws every batch from one
    key."""
    def make_batch(n):
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED)
        return {"tokens": torch.randint(0, cfg.vocab_size, (n, SEQ),
                                        generator=gen, device=device,
                                        dtype=torch.int32)}
    return make_batch


def run(cfg, device=None) -> dict:
    """Serve ``cfg`` under DNNScaler (SLO 8x the bs=1 latency, m=8, n=4,
    bs up to 32, mtl up to 4) for 40 engine steps; print the reference's
    five lines and return what they report, with the executor."""
    dev = resolve_device(device)
    params = api.init_params(cfg, seed=SEED, device=dev)
    n_params = sum(x.numel() for x in tensor_leaves(params))
    print(f"model: {cfg.name} ({n_params:,} params)")

    executor = RealExecutor(serve_fn_for(cfg), params, batch_maker(cfg, dev))
    base = executor.mean_latency(1, 1)
    slo = base * 8
    print(f"base latency {base * 1e3:.1f}ms -> SLO {slo * 1e3:.1f}ms")

    ctrl = DNNScalerController(executor, slo, m=8, n=4, max_bs=32, max_mtl=4)
    print(f"profiler: TI_B={ctrl.profile.ti_b:.0f}% "
          f"TI_MT={ctrl.profile.ti_mt:.0f}% -> {ctrl.approach}")

    engine = ServingEngine(executor, slo, instance_launch_s=0.05)
    acc = engine.run(ctrl, max_steps=40)
    s = acc.summary()
    a = ctrl.action()
    print(f"steady state: bs={a.bs} mtl={a.mtl}")
    print(f"served {s['items']} requests @ {s['throughput']:.1f}/s, "
          f"p95 {s['p95_s'] * 1e3:.1f}ms (SLO {slo * 1e3:.1f}ms), "
          f"attainment {s['slo_attainment']:.2f}")
    return {"base_s": base, "slo_s": slo, "approach": ctrl.approach,
            "steady": (a.bs, a.mtl), "summary": s, "executor": executor}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default the GPU (cpu: plain path)")
    args = ap.parse_args(argv)
    run(get_config("smollm-360m", tiny=True), args.device)


if __name__ == "__main__":
    main()
