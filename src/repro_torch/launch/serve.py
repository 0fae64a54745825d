"""Serving launcher: serve an assigned architecture on the device, or a
paper job, an LLM decode job or a whole fleet on the reference's simulated
devices, under a controller, and report the approach, steady knobs,
throughput and p95.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --real
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --real --autotune --profile-store .profile_store
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
        --tiny --real --device cpu --prompt-len 32 --new-tokens 4
    PYTHONPATH=src python -m repro_torch.launch.serve --token-engine \
        --slots 16 --requests 200

Counterpart of ``repro.launch.serve``.  On ``--arch ... --real`` a
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

``--token-engine`` serves a decode job token by token
(``serving.token_engine``; ``--prefill-mode disagg`` through
``serving.disagg``) priced on ``SimExecutor``, as the reference's does:
it needs no card, and ``--arch`` defaults to ``gemma2-2b``.  Its measured
counterpart is ``decode_executor_for``, a ``RealExecutor`` over one decode
step that ``token_engine.run_continuous`` drives slot bucket by slot
bucket.

The reference's other modes price its simulated devices on the host and
print what it prints: ``--job N`` (a paper job on a Tesla P40), ``--arch X``
without ``--real`` (an LLM decode job as a TPU-submesh tenancy on a TPU
v5e, mesh 16x16), ``--cluster`` (the 30 Table-4 jobs on a P40 fleet),
``--churn``, ``--partition`` and ``--scenarios`` (``serving.cluster``),
with ``--record NAME`` (a trace for ``report --replay``), ``--vectorized``
and ``--train-cost-model DEVCLASS``.  Their numbers are parity results,
not measurements of a card.  They run ``--steps`` 500 by default, as the
reference's; ``--real`` runs 40.

    PYTHONPATH=src python -m repro_torch.launch.serve --job 5
    PYTHONPATH=src python -m repro_torch.launch.serve --cluster \
        --controller hybrid --seconds 60 --devices 6
"""

from __future__ import annotations

import argparse
import os

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import InputShape, get_config, torch_dtype
from repro_torch.core.controller import (ClipperController, DNNScalerController,
                                         StaticController)
from repro_torch.core.matrix_completion import LatencyEstimator, SurfaceLibrary
from repro_torch.models import api
from repro_torch.perf import autotune
from repro_torch.perf.profile_store import ProfileStore
from repro_torch.serving import device_model as dm
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.executor import (ACT_MULT, RealExecutor,
                                          SimExecutor)
from repro_torch.serving.workload import PAPER_JOBS

PRICED_STEPS = 500   # --steps default of the priced modes, the reference's
REAL_STEPS = 40      # --steps default of --real


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


def decode_act_bytes(cfg) -> float:
    """Activation bytes one slot adds to a decode step: its float32 logits
    and, amplified by ``ACT_MULT`` as the executor amplifies a batch's
    bytes, one token's widest activations of a layer in the model's dtype
    (the residual and its norm, q, k and v, the gated MLP's two rows)."""
    row = (2 * cfg.d_model + (cfg.num_heads + 2 * cfg.num_kv_heads)
           * cfg.head_dim + 2 * cfg.d_ff)
    return 4.0 * cfg.vocab_size + ACT_MULT * row * torch_dtype(cfg).itemsize


def decode_executor_for(arch: str, tiny: bool = False, *, device=None,
                        prompt_len: int = 512, kv_budget: int = 1024,
                        seed: int = 0) -> tuple:
    """(RealExecutor, cfg, profile) over ONE decode step, the callable the
    token engine's ``run_token_step`` times: the bucket ladder is the slot
    ladder, and on a CUDA device each slot bucket is one CUDA graph.

    Where the cache lives: in each bucket's static batch.  ``make_batch(n)``
    prefills ``n`` random ``prompt_len``-token prompts (``api.make_batch``,
    seeded) into a cache of ``kv_budget`` positions and returns ``{"cache",
    "tokens": the prefill's argmax ids, "pos": prompt_len}`` on the device.
    The executor builds it once per bucket, charged to ``compile_time``
    with the capture, and keeps it as long as the bucket lives.  Every run
    decodes position ``prompt_len`` against that same cache: each step is a
    real decode step at a fixed depth, the cache never grows, and a slot's
    tokens are not its request's tokens (as the reference's ``run_step``
    replays its executable on the bucket's batch).

    Memory admission: on a CUDA device ``mem_bytes`` is the card's memory;
    a slot is charged its activations (``decode_act_bytes``, so ``fits``
    never prefills a batch to estimate them) and its KV cache at
    ``kv_budget`` positions (``kv_bytes_per_item``), as
    ``token_engine.memory_slot_cap`` requires.  ``profile`` is the priced
    decode profile at that budget, also set as ``executor.profile`` for
    ``run_continuous``; its ``prefill_ms`` is priced, and a caller that
    reports measured times replaces it with a measured prefill."""
    if not 0 < prompt_len < kv_budget:
        raise ValueError(f"prompt_len {prompt_len} must lie in (0, "
                         f"kv_budget {kv_budget})")
    dev = resolve_device(device)
    cfg = get_config(arch, tiny=tiny).replace(kernel_impl="pallas")
    params = api.init_params(cfg, seed=seed, device=dev)

    def step_fn(params, batch):
        return api.decode_step(params, batch["cache"], batch["tokens"],
                               batch["pos"], cfg)[0]

    def make_batch(n):
        shp = InputShape("decode", prompt_len, n, "prefill")
        prompt = api.make_batch(cfg, shp, seed=seed + 1, device=dev)
        logits, cache = api.prefill(params, prompt, cfg, capacity=kv_budget)
        return {"cache": cache, "tokens": logits.argmax(-1).to(torch.int32),
                "pos": torch.full((), prompt_len, dtype=torch.int32,
                                  device=dev)}

    mem = (torch.cuda.get_device_properties(dev).total_memory
           if dev.type == "cuda" else None)
    executor = RealExecutor(
        step_fn, params, make_batch, mem_bytes=mem,
        act_bytes_per_item=decode_act_bytes(cfg),
        kv_bytes_per_item=dm.kv_cache_bytes(
            cfg, kv_budget, dtype_bytes=torch_dtype(cfg).itemsize))
    profile = dm.llm_profile(cfg, mode="decode", kv_seq_budget=kv_budget)
    executor.profile = profile
    return executor, cfg, profile


def warn_truncated(agg: dict) -> None:
    if agg.get("truncated"):
        print("WARNING: run truncated at max_steps — metrics cover a "
              "partial horizon, not the full simulated window")


def serve_tokens(args) -> None:
    """``--token-engine``: one decode job served token by token, priced on
    ``SimExecutor``; the reference's ``serve --token-engine`` branch."""
    from repro_torch.serving.token_engine import (ragged_decode_trace,
                                                  run_token_serving)
    cfg = get_config(args.arch or "gemma2-2b")
    prof = dm.llm_profile(cfg, mode="decode", kv_seq_budget=1024)
    trace = ragged_decode_trace(args.requests, args.seed,
                                rate_rps=args.rate_rps)
    if args.prefill_mode == "disagg":
        from repro_torch.serving.disagg import run_disagg_serving
        rep = run_disagg_serving(
            prof, seed=args.seed, trace=trace,
            n_prefill=args.prefill_pool, kv_seq_budget=1024,
            max_slots=args.slots, mtl=args.mtl,
            ttft_slo_s=args.ttft_slo_ms / 1e3,
            tpot_slo_s=args.tpot_slo_ms / 1e3,
            use_controller=args.controller == "hybrid")
        warn_truncated(rep)
        assert rep["conserved"], "request conservation violated"
        fab = rep["fabric"]
        print(f"token-engine[{cfg.name}] disagg: "
              f"{args.prefill_pool}-member prefill pool over "
              f"{fab['interconnect']} "
              f"({fab['bw_bps'] / 1e9:.0f} GB/s): goodput "
              f"{rep['goodput_tokens_s']:.0f} tok/s, TTFT p95 "
              f"{rep['ttft_p95_s'] * 1e3:.0f}ms (attain "
              f"{rep['ttft_attainment']:.3f}), TPOT p95 "
              f"{rep['tpot_p95_s'] * 1e3:.2f}ms (attain "
              f"{rep['tpot_attainment']:.3f}), KV moved "
              f"{fab['bytes_moved'] / 1e9:.1f} GB in "
              f"{fab['transfers']} transfers "
              f"({fab['busy_s'] * 1e3:.0f}ms on the wire)")
        return
    policies = (["continuous", "static"] if args.token_policy == "both"
                else [args.token_policy])
    print(f"token-engine[{cfg.name}]: {len(trace)} requests @ "
          f"{args.rate_rps:.1f} req/s, {args.slots} slots, "
          f"prefill={args.prefill_mode}, TTFT SLO "
          f"{args.ttft_slo_ms:.0f}ms / TPOT SLO "
          f"{args.tpot_slo_ms:.1f}ms")
    reports = {}
    for pol in policies:
        rep = run_token_serving(
            prof, policy=pol, seed=args.seed, trace=trace,
            max_slots=args.slots, static_bs=args.slots, mtl=args.mtl,
            ttft_slo_s=args.ttft_slo_ms / 1e3,
            tpot_slo_s=args.tpot_slo_ms / 1e3,
            use_controller=args.controller == "hybrid",
            prefill_mode=args.prefill_mode,
            chunk_tokens=args.prefill_chunk)
        warn_truncated(rep)
        assert rep["conserved"], "request conservation violated"
        reports[pol] = rep
        print(f"  {pol:>10}: goodput {rep['goodput_tokens_s']:.0f} "
              f"tok/s (throughput {rep['throughput_tokens_s']:.0f}), "
              f"TTFT p95 {rep['ttft_p95_s']*1e3:.0f}ms "
              f"(attain {rep['ttft_attainment']:.3f}), TPOT p95 "
              f"{rep['tpot_p95_s']*1e3:.2f}ms "
              f"(attain {rep['tpot_attainment']:.3f}), "
              f"mean live slots {rep['mean_live_slots']:.1f}, "
              f"conservation OK")
    if len(reports) == 2:
        ratio = (reports["continuous"]["goodput_tokens_s"]
                 / max(reports["static"]["goodput_tokens_s"], 1e-9))
        print(f"  continuous/static goodput ratio: {ratio:.2f}x")


def scaler_mode(args, ap, flag: str) -> str:
    """The fleet runner's mode for ``--controller``: the fleets that
    re-place jobs take DNNScaler's loop only."""
    if args.controller not in ("dnnscaler", "hybrid"):
        ap.error(f"{flag} supports --controller dnnscaler or hybrid")
    return "hybrid" if args.controller == "hybrid" else "auto"


def serve_scenarios(args, ap, store) -> None:
    """``--scenarios``: one scenario-matrix cell on the simulated fleet."""
    from repro_torch.serving.cluster import run_scenario_cluster
    mode = scaler_mode(args, ap, "--scenarios")
    rep = run_scenario_cluster(
        args.scenario_traffic, spot=args.spot,
        power_policy=args.power_policy,
        n_devices=args.devices or 4,
        horizon_s=args.seconds or 150.0, mode=mode, seed=args.seed,
        vectorized=args.vectorized,
        record=args.record, record_store=store)
    agg = rep["aggregate"]
    warn_truncated(agg)
    assert agg["conserved"], "request conservation violated"
    cap = "spot" if args.spot else "fixed"
    jpg = agg["joules_per_good_request"]
    print(f"scenario[{args.scenario_traffic}/{cap}/"
          f"{args.power_policy or 'legacy'}]: {agg['jobs']} tenancies "
          f"on {agg['devices']} devices — goodput {agg['goodput']:.1f}"
          f"/s, min attainment {agg['min_attainment']:.3f}, "
          f"conservation OK")
    print(f"  energy {agg['energy_j']:.0f}J (idle "
          f"{agg['idle_energy_j']:.0f}J + dynamic "
          f"{agg['dynamic_energy_j']:.0f}J) on "
          f"{agg['devices_powered']} powered devices — "
          + (f"{jpg:.4f} J per good request" if jpg is not None
             else "no good requests"))
    if args.spot:
        print(f"  {agg['preemptions']} revocations: "
              f"{agg['preempt_evacuated']} tenants evacuated, "
              f"{agg['preempt_killed']} force-killed at the grace "
              f"deadline")
    for r in rep["per_job"]:
        share = f"{r['share']:.3f}" if r["share"] is not None else "—"
        flags = "".join(("P" if r["preempted"] else "",
                         "M" if r["migrations"] else ""))
        print(f"  job {r['job_id']:>5} {r['dnn']:<26} share {share:>6} "
              f"attain {r['slo_attainment']:.3f} {flags}")


def serve_partition(args, ap, store) -> None:
    """``--partition``: the mixed small/large trace on spatial slices."""
    from repro_torch.serving.cluster import run_partition_cluster
    mode = scaler_mode(args, ap, "--partition")
    rep = run_partition_cluster(args.partition_policy, mode=mode,
                                n_devices=args.devices or 3,
                                horizon_s=args.seconds or 120.0,
                                seed=args.seed, profile_store=store,
                                vectorized=args.vectorized,
                                record=args.record, record_store=store)
    agg = rep["aggregate"]
    warn_truncated(agg)
    assert agg["conserved"], "request conservation violated"
    print(f"partition[{args.partition_policy}/{mode}]: {agg['jobs']} "
          f"tenancies on {agg['devices']} devices "
          f"(kind={agg['partition']}) — goodput {agg['goodput']:.1f}/s, "
          f"throughput {agg['aggregate_throughput']:.1f}/s")
    print(f"  {agg['resizes']} resizes "
          f"({agg['resize_stall_s']:.2f}s stalls vs "
          f"{agg['resize_equiv_migration_stall_s']:.1f}s had each been "
          f"a migration), {agg['migrations']} migrations "
          f"({agg['migration_stall_s']:.1f}s)")
    for r in rep["per_job"]:
        share = f"{r['share']:.3f}" if r["share"] is not None else "—"
        print(f"  job {r['job_id']:>5} {r['dnn']:<26} share {share:>6} "
              f"bs {r['bs']:>3} mtl {r['mtl']:>2} "
              f"thr {r['throughput']:>7.1f}/s "
              f"attain {r['slo_attainment']:.3f}")


def serve_churn(args, ap, store) -> None:
    """``--churn``: jobs admit and drain mid-run on the simulated fleet."""
    from repro_torch.serving.cluster import run_churn_cluster
    mode = scaler_mode(args, ap, "--churn")
    rep = run_churn_cluster(args.churn_policy, mode=mode,
                            n_devices=args.devices or 5,
                            horizon_s=args.seconds or 150.0,
                            seed=args.seed, profile_store=store,
                            vectorized=args.vectorized,
                            record=args.record, record_store=store)
    agg = rep["aggregate"]
    warn_truncated(agg)
    assert agg["conserved"], "request conservation violated"
    print(f"churn[{args.churn_policy}/{mode}]: {agg['jobs']} tenancies "
          f"on {agg['devices']} devices — goodput {agg['goodput']:.1f}"
          f"/s, throughput {agg['aggregate_throughput']:.1f}/s, "
          f"{agg['admissions']} admissions / {agg['drains']} drains / "
          f"{agg['migrations']} migrations "
          f"({agg['migration_stall_s']:.1f}s stalls), "
          f"conservation OK")
    if store is not None:
        s = store.stats()
        print(f"  profile store {s['root']}: "
              f"{rep['aggregate'].get('store_rows_loaded', 0)} rows "
              f"loaded / {rep['aggregate'].get('store_rows_evicted', 0)} "
              f"evicted on load; now "
              f"{s['sections'].get('surfaces', 0)} surface rows, "
              f"{s['sections'].get('migrations', 0)} migration "
              f"calibrations")


def serve_cluster(args, ap, store) -> None:
    """``--cluster``: the 30 Table-4 jobs on a simulated P40 fleet."""
    from repro_torch.serving.cluster import run_paper_cluster
    if args.controller == "static":
        ap.error("--controller static is not supported with --cluster "
                 "(per-job static knobs have no cluster-wide meaning); "
                 "choose dnnscaler, hybrid, or clipper")
    for flag, val, default in (("--job", args.job, None),
                               ("--arch", args.arch, None),
                               ("--slo-ms", args.slo_ms, None),
                               ("--bs", args.bs, 1),
                               ("--mtl", args.mtl, 1)):
        if val != default:
            ap.error(f"{flag} has no effect with --cluster "
                     "(jobs use their Table-4 SLOs and scaler-chosen "
                     "knobs)")
    mode = {"dnnscaler": "auto", "hybrid": "hybrid",
            "clipper": "clipper"}[args.controller]
    rep = run_paper_cluster(mode, n_devices=args.devices or 12,
                            sim_time_limit=args.seconds or 90.0,
                            seed=args.seed, vectorized=args.vectorized,
                            record=args.record, record_store=store)
    agg = rep["aggregate"]
    warn_truncated(agg)
    print(f"cluster[{mode}]: {agg['jobs']} jobs on {agg['devices']} "
          f"devices — aggregate {agg['aggregate_throughput']:.1f} "
          f"items/s, {agg['jobs_meeting_slo']}/{agg['feasible_jobs']} "
          f"feasible jobs meet SLO, stalls {agg['total_stall_s']:.1f}s")


def train_cost_model(args, store) -> None:
    """``--train-cost-model DEVCLASS``: fit the cost model from the
    store's surface rows, save it there, and report."""
    from repro_torch.perf import cost_model as cm
    dc = args.train_cost_model
    model = cm.train_cost_model(store, dc,
                                autotune_generation=autotune.generation())
    if model is None:
        rows = sum(1 for r in store.section("surfaces").values()
                   if isinstance(r, dict)
                   and r.get("device_class") == dc)
        print(f"cost model[{dc}]: NOT trained — {rows} surface rows "
              f"for this device class; need >= 4 with recognizable "
              f"signatures and a device model (tesla-p40 / tpu-v5e)")
        return
    cm.save_cost_model(store, model)
    store.save()
    print(f"cost model[{dc}]: trained on {model.n_rows} surface rows "
          f"({len(model.train_signatures)} signatures), "
          f"{len(model.rung_factors)} share-rung factors — saved to "
          f"{store.path}")


def serve_priced(args) -> None:
    """``--job N`` (a paper job on the simulated P40) or ``--arch X``
    without ``--real`` (an LLM decode job as a TPU-submesh tenancy on the
    simulated TPU v5e, mesh 16x16): the reference's priced single-job
    loop on ``SimExecutor``."""
    if args.job is not None:
        job = PAPER_JOBS[args.job - 1]
        prof = job.profile()
        slo = args.slo_ms / 1e3 if args.slo_ms else job.slo_s
        executor = SimExecutor(prof, seed=args.seed)
        ctrl = make_controller(args.controller, executor, slo, job.job_id,
                               args.bs, args.mtl)
        engine = ServingEngine(SimExecutor(prof, seed=args.seed + 1), slo)
        label = f"job{job.job_id} {prof.name}"
    else:
        cfg = get_config(args.arch)
        prof = dm.llm_profile(cfg, mode="decode")
        base = dm.batch_latency(dm.TPU_V5E, prof, 1)
        slo = args.slo_ms / 1e3 if args.slo_ms else base * 4
        executor = SimExecutor(prof, device=dm.TPU_V5E, seed=args.seed,
                               mesh_shape=(16, 16))
        ctrl = make_controller(args.controller, executor, slo)
        engine = ServingEngine(
            SimExecutor(prof, device=dm.TPU_V5E, seed=args.seed + 1,
                        mesh_shape=(16, 16)), slo)
        label = f"{cfg.name} (TPU submesh tenancy)"
    run_one(args, engine, ctrl, slo, label, PRICED_STEPS, power=True)
    print_probes(ctrl)


def run_one(args, engine, ctrl, slo: float, label: str, default_steps: int,
            *, power: bool) -> dict:
    """Serve one job under ``ctrl`` for ``--steps`` (``default_steps``
    when not given) and print the steady knobs, throughput, p95 against
    the SLO and attainment (and power efficiency with ``power``, as the
    priced modes print it).  Returns the run's summary."""
    acc = engine.run(ctrl, max_steps=default_steps if args.steps is None
                     else args.steps)
    s = acc.summary()
    act = ctrl.action()
    approach = getattr(ctrl, "approach", args.controller)
    print(f"{label}: controller={args.controller} approach={approach} "
          f"steady(bs={act.bs}, mtl={act.mtl})")
    print(f"  throughput {s['throughput']:.1f}/s  p95 {s['p95_s']*1e3:.1f}ms "
          f"(SLO {slo*1e3:.1f}ms)  attainment {s['slo_attainment']:.3f}"
          + (f"  power_eff {s['power_efficiency']:.2f}/W" if power else ""))
    return s


def print_probes(ctrl) -> None:
    if hasattr(ctrl, "probe_count"):
        print(f"  probes: {ctrl.probe_count} distinct (bs, mtl) points")


def serve_real(args, store) -> None:
    """``--arch X --real``: the model served on the device."""
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
    s = run_one(args, engine, ctrl, slo,
                f"{cfg.name} (real, {executor.device.type})", REAL_STEPS,
                power=False)
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
    print_probes(ctrl)
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--job", type=int, default=None, help="paper job # (1-30)")
    ap.add_argument("--arch", default=None,
                    help="assigned architecture id (--token-engine: "
                         "default gemma2-2b)")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--real", action="store_true",
                    help="wall-clock executor on the device")
    ap.add_argument("--controller", default="dnnscaler",
                    choices=["dnnscaler", "hybrid", "clipper", "static"])
    ap.add_argument("--cluster", action="store_true",
                    help="serve the full 30-job trace on a simulated fleet")
    ap.add_argument("--churn", action="store_true",
                    help="online churn: jobs admit/drain mid-run with "
                         "migration-aware re-placement")
    ap.add_argument("--churn-policy", default="surface",
                    choices=["union", "dynamic", "surface"],
                    help="placement policy for --churn (see "
                         "serving.cluster.run_churn_cluster)")
    ap.add_argument("--token-engine", action="store_true",
                    help="token-level continuous batching for a decode "
                         "job: bs = max live decode slots, admit-on-free-"
                         "slot / evict-on-EOS, TTFT+TPOT SLOs "
                         "(serving.token_engine), priced")
    ap.add_argument("--token-policy", default="both",
                    choices=["continuous", "static", "both"],
                    help="slot engine, fixed-shape bucketed baseline, or "
                         "both on the same ragged trace")
    ap.add_argument("--slots", type=int, default=16,
                    help="max live decode slots (continuous) / batch size "
                         "(static baseline) for --token-engine")
    ap.add_argument("--requests", type=int, default=300,
                    help="trace length for --token-engine")
    ap.add_argument("--rate-rps", type=float, default=12.0,
                    help="arrival rate for the --token-engine trace")
    ap.add_argument("--ttft-slo-ms", type=float, default=1000.0)
    ap.add_argument("--tpot-slo-ms", type=float, default=50.0)
    ap.add_argument("--prefill-mode", default="cotenant",
                    choices=["cotenant", "timeslice", "chunked", "disagg"],
                    help="prefill priced as a co-resident tenant, "
                         "time-sliced on the decode tenant, split into "
                         "fixed token-budget chunks piggybacked on decode "
                         "steps, or disaggregated onto a dedicated "
                         "prefill pool with KV streamed over the "
                         "interconnect (serving.disagg)")
    ap.add_argument("--prefill-pool", type=int, default=2,
                    help="--prefill-mode disagg: prefill-pool members")
    ap.add_argument("--prefill-chunk", type=int, default=256,
                    help="--prefill-mode chunked: prefill tokens "
                         "piggybacked per decode step")
    ap.add_argument("--scenarios", action="store_true",
                    help="one scenario-matrix cell: time-varying traffic "
                         "x spot capacity x power packing on the MPS "
                         "partition planner (see "
                         "serving.cluster.run_scenario_cluster)")
    ap.add_argument("--scenario-traffic", default="steady",
                    choices=["steady", "diurnal", "flash"],
                    help="traffic shape for --scenarios: constant, "
                         "compressed diurnal swing, or a 3x flash crowd")
    ap.add_argument("--spot", action="store_true",
                    help="--scenarios: mark one device preemptible and "
                         "revoke it once mid-run (grace window, restore)")
    ap.add_argument("--power-policy", default=None,
                    choices=["pack", "spread"],
                    help="--scenarios placement objective: consolidate "
                         "tenants to power-gate idle devices, or spread "
                         "for headroom (default: legacy scoring)")
    ap.add_argument("--partition", action="store_true",
                    help="spatial partitioning (MPS/MIG-style slices): "
                         "serve the mixed small/large trace with the "
                         "share knob active")
    ap.add_argument("--partition-policy", default="het",
                    choices=["uniform", "het", "het-mig"],
                    help="uniform = 1/k time-share baseline (same pricing "
                         "model, migrations); het = heterogeneous MPS "
                         "shares + cheap resizes; het-mig = MIG grid")
    ap.add_argument("--devices", type=int, default=None,
                    help="fleet size for --cluster / --churn "
                         "(default 12 / 5)")
    ap.add_argument("--seconds", type=float, default=None,
                    help="simulated-time horizon for --cluster / --churn "
                         "(default 90 / 150)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="--real: the device the model runs on")
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--max-bs", type=int, default=64)
    ap.add_argument("--max-mtl", type=int, default=4)
    ap.add_argument("--bs", type=int, default=1)
    ap.add_argument("--mtl", type=int, default=1)
    ap.add_argument("--slo-ms", type=float, default=None)
    ap.add_argument("--steps", type=int, default=None,
                    help=f"serving steps (default {PRICED_STEPS}; "
                         f"{REAL_STEPS} with --real)")
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
                         "rows / migration calibrations before serving and "
                         "persist this run's probing afterwards")
    ap.add_argument("--train-cost-model", default=None, metavar="DEVCLASS",
                    help="maintenance action: train the learned cost model "
                         "for DEVCLASS (e.g. tesla-p40) from the "
                         "--profile-store's persisted surface rows, save "
                         "it into the store's cost_model section, and "
                         "exit.  The next cluster boot serves it as the "
                         "zero-probe prediction tier (perf.cost_model)")
    ap.add_argument("--record", default=None, metavar="NAME",
                    help="record this cluster/churn/partition run's inputs "
                         "and event stream into the profile store under "
                         "NAME, for later `report --replay NAME` what-if "
                         "analysis")
    ap.add_argument("--vectorized", action="store_true",
                    help="use the array-backed VectorClusterEngine "
                         "(bit-identical results, faster at fleet scale)")
    args = ap.parse_args()

    autotune.configure(cache_dir=args.autotune_cache_dir,
                       tune_on_miss=args.autotune or None)
    store = None
    if args.profile_store is not None:
        store = ProfileStore(args.profile_store)
        if args.autotune_cache_dir is None and \
                not os.environ.get("REPRO_AUTOTUNE_CACHE"):
            # one store for all three artifacts: the tuned-knob generation
            # that gates the persisted surface rows must come from the
            # document they are in
            autotune.configure(cache_dir=args.profile_store)

    if args.record and not (args.cluster or args.churn or args.partition
                            or args.scenarios):
        ap.error("--record applies to --cluster / --churn / --partition "
                 "/ --scenarios runs only")
    if args.train_cost_model is not None:
        if store is None:
            ap.error("--train-cost-model requires --profile-store (the "
                     "model is trained from its persisted surface rows)")
        train_cost_model(args, store)
    elif args.token_engine:
        serve_tokens(args)
    elif args.scenarios:
        serve_scenarios(args, ap, store)
    elif args.partition:
        serve_partition(args, ap, store)
    elif args.churn:
        serve_churn(args, ap, store)
    elif args.cluster:
        serve_cluster(args, ap, store)
    elif args.job is None and args.arch and args.real:
        serve_real(args, store)
    else:
        serve_priced(args)


if __name__ == "__main__":
    main()
