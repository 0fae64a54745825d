"""Cross-run warm start: the second process pays less than the first; the
counterpart of the reference's ``examples/warm_start.py``.

One serving 'process' = a fresh executor + hybrid DNNScalerController,
with EVERYTHING cross-run flowing through the persistent profile store
(`perf.profile_store`): the run reloads persisted surface rows before
serving and persists its own probed row afterwards.

The executor is a RealExecutor whose bucket misses are REALLY paid (a
CUDA-graph capture on the GPU, an eager warm-up run on the CPU) — the
stall the store amortizes — while the step latency the
controller observes comes from the calibrated analytic device model with
seeded noise.  Real wall-clock latency on a shared CI host swings 2-3x
between runs, which would turn a cold-vs-warm trajectory comparison into
a coin flip; the deterministic surface keeps the probe trajectories
reproducible while every bucket the search touches still pays its real
compile.  (Sim-vs-real latency fidelity is tested separately in
tests/test_conformance.py.)

The cold run climbs the (bs, mtl) knob space from scratch — every probe
is a new operating point and many land in new batch buckets, each paying
a capture stall.  The warm run (same store dir, fresh process) finds
the previous run's persisted row, seeds + starts its scaler from the
matrix-completion prediction (including the infeasible-frontier pins the
cold run paid probes to discover), and reaches steady state in strictly
fewer distinct probes with strictly lower compile-stall seconds.

    PYTHONPATH=src python -m repro_torch.examples.warm_start [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.warm_start \
        --store DIR --phase cold
    PYTHONPATH=src python -m repro_torch.examples.warm_start \
        --store DIR --phase warm

The one-shot default runs cold then warm against a fresh store dir; the
--phase form demonstrates the same thing across two real OS processes.
"""

import argparse
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.core.controller import DNNScalerController
from repro_torch.core.matrix_completion import SurfaceLibrary
from repro_torch.perf import autotune
from repro_torch.perf.profile_store import ProfileStore
from repro_torch.serving import device_model as dm
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.executor import RealExecutor
from repro_torch.serving.workload import PAPER_JOBS

SIGNATURE = "warmstart-inception_v4/imagenet"
DEVICE_CLASS = "host-cpu"
# inception_v4/imagenet (Table-4 job 3): a Batching job with a LONG climb
# (paper steady BS 28) — the cold search pays many probes and bucket
# compiles walking up, which is exactly the cost a warm start amortizes
JOB = PAPER_JOBS[2]
WIDTH = 128


class WarmLabExecutor(RealExecutor):
    """RealExecutor with a deterministic latency surface.

    Bucket misses are real (a CUDA-graph capture on the GPU, an eager
    warm-up on the CPU: `cache_stats`, ``result["compile_time"]`` — the
    engine charges them as stalls); the
    reported step latency is the calibrated analytic model + seeded
    noise, so the scaler's probe trajectory is reproducible."""

    def __init__(self, profile: dm.JobProfile,
                 device: dm.Device = dm.TESLA_P40, seed: int = 0,
                 torch_device=None):
        dev = resolve_device(torch_device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = [torch.randn((WIDTH, WIDTH), generator=gen, device=dev)
                  * 0.05 for _ in range(2)]

        def fn(params, batch):
            x = batch["x"]
            for w in params:
                x = torch.tanh(x @ w)
            return x.sum()

        def make_batch(n):
            return {"x": torch.ones((n, WIDTH), dtype=torch.float32,
                                    device=dev)}

        super().__init__(fn, params, make_batch)
        self.profile = profile
        self.sim_device = device        # self.device is the torch device
        self.sampler = dm.LatencySampler(seed=seed)

    def mean_latency(self, bs: int, mtl: int = 1, iters: int = 3) -> float:
        return dm.mt_latency(self.sim_device, self.profile, bs, mtl)

    def run_step(self, bs: int, mtl: int) -> dict:
        res = super().run_step(bs, mtl)     # real execution + compile bill
        mean = dm.mt_latency(self.sim_device, self.profile, bs, mtl)
        lat = float(self.sampler.sample(mean, n=1)[0])
        items = bs * mtl
        res.update(step_time=lat,
                   request_latencies=self.sampler.sample(
                       lat, n=min(items, 64)),
                   throughput=items / lat)
        return res


def serve_once(store_dir: str, *, steps: int = 160, seed: int = 0,
               device=None) -> dict:
    """One serving process.  All cross-run state lives in the store on
    disk, so calling this twice IS the two-process experiment."""
    store = ProfileStore(store_dir)
    lib = SurfaceLibrary()
    gen = autotune.generation()
    res = store.load_surfaces(lib, device_class=DEVICE_CLASS,
                              autotune_generation=gen)
    ex = WarmLabExecutor(JOB.profile(), seed=seed, torch_device=device)
    ctrl = DNNScalerController(ex, JOB.slo_s, mode="hybrid",
                               surface_library=lib, surface_key="tenant")
    engine = ServingEngine(ex, JOB.slo_s)
    acc = engine.run(ctrl, max_steps=steps)
    # tile_dependent=False: the latency surface is the analytic model,
    # so a kernel re-tune cannot invalidate it
    store.persist_surface(lib, "tenant", signature=SIGNATURE,
                          device_class=DEVICE_CLASS,
                          autotune_generation=gen, tile_dependent=False)
    store.save()
    last = [(bs, mtl) for _, bs, mtl, *_ in acc.trace[-40:]]
    return {
        "loaded_rows": len(res["loaded"]),
        "probes": ctrl.probe_count,
        "compiles": ex.cache_stats.misses,
        "compile_stall_s": acc.compile_stall_s,
        "steady": max(set(last), key=last.count),
        "throughput": acc.throughput,
        "slo_ms": JOB.slo_ms,
    }


def show(label: str, r: dict) -> None:
    print(f"{label:>5}: {r['loaded_rows']} persisted rows loaded, "
          f"{r['probes']} probes, {r['compiles']} bucket compiles "
          f"({r['compile_stall_s'] * 1e3:.0f}ms compile stalls), "
          f"steady (bs={r['steady'][0]}, mtl={r['steady'][1]}), "
          f"{r['throughput']:.0f} items/s (SLO {r['slo_ms']:.1f}ms)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--store", default=None,
                    help="profile store dir (default: a fresh temp dir)")
    ap.add_argument("--phase", default="both",
                    choices=["both", "cold", "warm"],
                    help="'cold'/'warm' run ONE phase (two real OS "
                         "processes against the same --store); 'both' "
                         "runs the whole experiment in one go")
    ap.add_argument("--steps", type=int, default=160)
    ap.add_argument("--device", default=None,
                    help="torch device; default the GPU (cpu: eager warm-up)")
    args = ap.parse_args(argv)

    store_dir = args.store or tempfile.mkdtemp(prefix="profile_store_")
    print(f"profile store: {store_dir}")
    cold = warm = None
    if args.phase in ("both", "cold"):
        cold = serve_once(store_dir, steps=args.steps,
                          device=args.device)
        show("cold", cold)
    if args.phase in ("both", "warm"):
        warm = serve_once(store_dir, steps=args.steps,
                          device=args.device)
        show("warm", warm)
    if args.phase == "warm" and not warm["loaded_rows"]:
        print("store was empty — run --phase cold against the same "
              "--store first")
        return
    if cold is not None and warm is not None:
        ok = (warm["probes"] < cold["probes"]
              and warm["compile_stall_s"] < cold["compile_stall_s"])
        print(f"warm run reaches steady state in fewer probes "
              f"({warm['probes']} < {cold['probes']}) with lower compile "
              f"stalls ({warm['compile_stall_s'] * 1e3:.0f}ms < "
              f"{cold['compile_stall_s'] * 1e3:.0f}ms): "
              f"{'PASS' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(1)       # scripts/CI gate on the exit status


if __name__ == "__main__":
    main()
