"""Workloads: the paper's 30-job table (Table 4), LLM serving jobs built
from the assigned architectures, and online churn traces (jobs that arrive
and depart mid-run — the regime ClusterEngine's dynamic mode serves)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving import device_model as dm


@dataclasses.dataclass(frozen=True)
class Job:
    job_id: int
    dnn: str
    dataset: str
    slo_ms: float
    paper_method: Optional[str] = None   # what the paper's Table 4 chose
    paper_steady: Optional[int] = None   # steady BS or MTL in Table 4
    # LLM / synthetic jobs carry their profile directly instead of the
    # Table-5 calibration lookup
    profile_override: Optional[dm.JobProfile] = None

    @property
    def slo_s(self) -> float:
        return self.slo_ms / 1e3

    def profile(self) -> dm.JobProfile:
        if self.profile_override is not None:
            return self.profile_override
        return dm.paper_profile(self.dnn, self.dataset)


# Paper Table 4 — job #, DNN, dataset, SLO(ms), DNNScaler method, steady knob.
PAPER_JOBS = [
    Job(1,  "inception_v1",    "imagenet",     35,   "MT", 8),
    Job(2,  "inception_v2",    "imagenet",     53,   "MT", 9),
    Job(3,  "inception_v4",    "imagenet",     419,  "B",  28),
    Job(4,  "mobilenet_v1_05", "imagenet",     199,  "MT", 10),
    Job(5,  "mobilenet_v1_025", "imagenet",    186,  "MT", 10),
    Job(6,  "mobilenet_v2_1",  "imagenet",     81,   "MT", 10),
    Job(7,  "nasnet_large",    "imagenet",     417,  "B",  13),
    Job(8,  "nasnet_mobile",   "imagenet",     85,   "MT", 10),
    Job(9,  "pnasnet_mobile",  "imagenet",     82,   "MT", 10),
    Job(10, "resnet_v2_50",    "imagenet",     45,   "MT", 6),
    Job(11, "resnet_v2_101",   "imagenet",     72,   "B",  4),
    Job(12, "resnet_v2_152",   "imagenet",     206,  "B",  14),
    Job(13, "resnet_v2_101",   "imagenet",     107,  "B",  7),
    Job(14, "inception_v1",    "caltech",      48,   "MT", 10),
    Job(15, "inception_v2",    "caltech",      116,  "B",  16),
    Job(16, "inception_v3",    "caltech",      322,  "B",  37),
    Job(17, "inception_v4",    "caltech",      139,  "B",  10),
    Job(18, "mobilenet_v1_1",  "caltech",      89,   "MT", 10),
    Job(19, "mobilenet_v1_05", "caltech",      60,   "MT", 10),
    Job(20, "mobilenet_v1_025", "caltech",     104,  "MT", 10),
    Job(21, "mobilenet_v2_1",  "caltech",      129,  "MT", 10),
    Job(22, "pnasnet_large",   "caltech",      524,  "B",  19),
    Job(23, "pnasnet_mobile",  "caltech",      321,  "B",  50),
    Job(24, "resnet_v2_50",    "caltech",      31,   "B",  1),
    Job(25, "resnet_v2_101",   "caltech",      107,  "B",  10),
    Job(26, "textclassif",     "sentiment140", 3.5,  "B",  102),
    Job(27, "textclassif",     "imdb",         3,    "B",  76),
    Job(28, "deepspeech2",     "librispeech",  1250, "B",  28),
    Job(29, "deepvs",          "ledov",        3000, "MT", 6),
    Job(30, "deepvs",          "dhf1k",        5000, "MT", 8),
]


def llm_jobs(slo_scale: float = 4.0):
    """LLM serving jobs from the assigned architectures (decode mode)."""
    from repro_torch.configs.base import ARCH_IDS, get_config
    from repro_torch.serving.device_model import TPU_V5E, llm_profile, step_latency
    jobs = []
    for i, arch in enumerate(ARCH_IDS):
        cfg = get_config(arch)
        prof = llm_profile(cfg, mode="decode")
        base = step_latency(TPU_V5E, prof, 1)["t_step"]
        jobs.append((arch, prof, base * slo_scale))
    return jobs


def llm_serving_jobs(slo_scale: float = 4.0, *, job_id_base: int = 900,
                     archs: Optional[Sequence[str]] = None) -> List[Job]:
    """The assigned-architecture decode jobs as first-class `Job`s, so churn
    traces can mix them into the Table-4 pool.  The SLO is `slo_scale` x the
    single-stream decode step on a whole TPU v5e — generous enough that the
    job stays feasible on a fractional slice."""
    from repro_torch.configs.base import get_config
    picked = list(archs) if archs is not None else \
        ["smollm-360m", "gemma2-2b", "mamba2-1p3b"]
    jobs = []
    for i, arch in enumerate(picked):
        cfg = get_config(arch)
        prof = dm.llm_profile(cfg, mode="decode")
        base = dm.step_latency(dm.TPU_V5E, prof, 1)["t_step"]
        jobs.append(Job(job_id=job_id_base + i, dnn=cfg.name, dataset="decode",
                        slo_ms=base * slo_scale * 1e3, profile_override=prof))
    return jobs


def long_prefill_trace(n_requests: int = 300, seed: int = 0, *,
                       rate_rps: float = 12.0, prefill_mean: int = 2048,
                       decode_mean: int = 96, decode_sigma: float = 0.8):
    """Long-prompt ragged decode trace (summarization / RAG style):
    prompts average `prefill_mean` >= 2048 tokens while outputs stay
    short — the regime where prompt processing, not decode, owns the
    device and prefill/decode disaggregation pays (serving/disagg.py,
    benchmarks/disagg_benches.py)."""
    from repro_torch.serving.token_engine import ragged_decode_trace
    if prefill_mean < 2048:
        raise ValueError("long_prefill_trace is the long-prompt regime: "
                         "prefill_mean >= 2048")
    return ragged_decode_trace(n_requests, seed, rate_rps=rate_rps,
                               prefill_mean=prefill_mean,
                               decode_mean=decode_mean,
                               decode_sigma=decode_sigma)


# ---------------------------------------------------------------------------
# Online churn traces: per-job admit/depart times over a horizon.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ChurnJob:
    """One serving tenancy in a churn trace: a job that arrives at
    `admit_s`, departs at `depart_s` (None = stays to the horizon), and —
    in open-loop mode — receives Poisson arrivals at `arrival_rate`/s
    strictly inside its [admit_s, depart_s) lifetime."""

    job: Job
    admit_s: float = 0.0
    depart_s: Optional[float] = None
    arrival_rate: Optional[float] = None
    # declarative time-varying traffic over the nominal arrival_rate (which
    # stays the mean-rate the packer scores against): a plain dict so churn
    # traces remain JSON-serializable for replay.  See `make_rate_fn` for
    # the supported kinds ("diurnal", "flash"); None = constant rate.
    traffic: Optional[dict] = None


def make_rate_fn(base_rate: Optional[float], traffic: Optional[dict]):
    """Compile a ChurnJob's declarative `traffic` spec into the arrival
    machinery: returns ``(rate_fn, piecewise_s, step_breaks)`` for
    `OpenLoopQueue`.

    - None / {"kind": "steady"}: constant `base_rate` — the exact
      single-point integral, bit-identical to the legacy constant path.
    - {"kind": "diurnal", "period_s", "peak_mult", "trough_mult",
      "phase_s"}: smooth cosine day/night swing between trough_mult and
      peak_mult x base_rate (trough at phase_s, peak half a period later);
      integrated by trapezoid over period/16 knots.
    - {"kind": "flash", "at_s", "duration_s", "mult"}: flash crowd — a
      step to mult x base_rate over [at_s, at_s + duration_s); the jump
      points are REGISTERED so the integral is exact left-Riemann (the
      trapezoid would smear the spike edges; see OpenLoopQueue).
    """
    if base_rate is None or traffic is None:
        return (lambda t, r=base_rate: r), None, None
    kind = traffic.get("kind", "steady")
    if kind == "steady":
        return (lambda t, r=base_rate: r), None, None
    if kind == "diurnal":
        period = float(traffic.get("period_s", 86_400.0))
        peak = float(traffic.get("peak_mult", 2.0))
        trough = float(traffic.get("trough_mult", 0.5))
        phase = float(traffic.get("phase_s", 0.0))

        def rate_fn(t, r=base_rate):
            u = 0.5 * (1.0 - np.cos(2.0 * np.pi * (t - phase) / period))
            return r * (trough + (peak - trough) * float(u))

        return rate_fn, period / 16.0, None
    if kind == "flash":
        at = float(traffic.get("at_s", 0.0))
        dur = float(traffic.get("duration_s", 10.0))
        mult = float(traffic.get("mult", 4.0))

        def rate_fn(t, r=base_rate):
            return r * (mult if at <= t < at + dur else 1.0)

        def step_breaks(a, b):
            return [x for x in (at, at + dur) if a < x < b]

        return rate_fn, None, step_breaks
    raise ValueError(f"unknown traffic kind {kind!r}")


# ---------------------------------------------------------------------------
# Preemptible (spot) capacity: revocation events over the fleet.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Preemption:
    """One spot-capacity revocation: device index `device` is revoked at
    `at_s`; residents get a `grace_s` evacuation window (migrate out, or
    serve down until the deadline and lose the remaining backlog).
    `restore_s` optionally returns the device to the placement pool."""

    device: int
    at_s: float
    grace_s: float = 10.0
    restore_s: Optional[float] = None


def spot_revocation_trace(fleet: Sequence, *, horizon_s: float,
                          grace_s: float = 10.0, restore: bool = True,
                          seed: int = 0) -> List[Preemption]:
    """One revocation per spot-flagged device, at a time sampled from the
    middle 60% of the horizon; restored (if `restore`) after ~15% of the
    horizon off — the churn shape of a preemptible capacity pool."""
    rng = np.random.default_rng(seed)
    out: List[Preemption] = []
    for d, spec in enumerate(fleet):
        dev = getattr(spec, "device", spec)
        if not getattr(dev, "spot", False):
            continue
        at = float(rng.uniform(0.2 * horizon_s, 0.8 * horizon_s))
        back = at + grace_s + 0.15 * horizon_s
        out.append(Preemption(
            device=d, at_s=at, grace_s=grace_s,
            restore_s=(back if restore and back < horizon_s else None)))
    out.sort(key=lambda p: p.at_s)
    return out


def steady_capacity(job: Job, *, share: float = 1.0,
                    alpha: float = 0.85) -> float:
    """SLO-feasible steady throughput of `job` on a `share`-sized slice of
    its natural device: the best (bs, mtl) grid point whose analytic
    latency fits under alpha*SLO.  Falls back to the single-stream rate
    when even (1, 1) violates (the job is served best-effort anyway)."""
    prof = job.profile()
    dev = dm.TPU_V5E if job.profile_override is not None else dm.TESLA_P40
    if share < 1.0:
        dev = dev.share(share)
    bs = np.array([1, 2, 4, 8, 16, 32, 64, 128])
    mtl = np.arange(1, 11)
    lat = dm.mt_latency_grid(dev, prof, bs, mtl)
    best = dm.best_feasible_point(lat, bs, mtl, alpha * job.slo_s)
    if best is None:
        return 1.0 / dm.batch_latency(dev, prof, 1)
    return best[0]


def mixed_partition_trace(*, horizon_s: float = 120.0, n_light: int = 4,
                          heavy_load: float = 0.7, light_load: float = 0.6,
                          seed: int = 0) -> List[ChurnJob]:
    """A mixed small/large-DNN trace — the regime where heterogeneous
    spatial shares beat uniform multi-tenancy.

    Two HEAVY jobs (large dense nets whose GPU time dominates) are present
    for the whole horizon with arrival rates sized to their SLO-feasible
    capacity on a ~3/4 device slice: a uniform 1/k time-share physically
    cannot serve them once a couple of light tenants land on the device.
    `n_light` LIGHT jobs (tiny mobile/text nets that keep up on an eighth
    of a device) churn in and out, forcing the placement layer to
    repeatedly re-divide each device — resizes in partition mode, full
    kill+relaunch migrations under uniform sharing."""
    rng = np.random.default_rng(seed)
    heavy_pool = [j for j in PAPER_JOBS
                  if j.dnn in ("inception_v4", "resnet_v2_152",
                               "nasnet_large")]
    light_pool = [j for j in PAPER_JOBS
                  if j.dnn in ("mobilenet_v1_025", "mobilenet_v1_05",
                               "textclassif")]
    trace: List[ChurnJob] = []
    for k in range(2):
        base = heavy_pool[int(rng.integers(len(heavy_pool)))]
        job = dataclasses.replace(base, job_id=2000 + k)
        trace.append(ChurnJob(
            job=job, admit_s=0.0, depart_s=None,
            arrival_rate=heavy_load * steady_capacity(job, share=0.75)))
    for k in range(n_light):
        base = light_pool[int(rng.integers(len(light_pool)))]
        job = dataclasses.replace(base, job_id=2100 + k)
        admit = 0.0 if k == 0 else float(rng.uniform(0.0, 0.6 * horizon_s))
        life = float(rng.exponential(0.35 * horizon_s))
        depart = admit + life if admit + life < horizon_s else None
        trace.append(ChurnJob(
            job=job, admit_s=admit, depart_s=depart,
            arrival_rate=light_load * steady_capacity(job, share=0.125)))
    trace.sort(key=lambda e: e.admit_s)
    return trace


def churn_trace(*, horizon_s: float = 150.0, n_initial: int = 4,
                n_churn: int = 12, mean_lifetime_s: float = 30.0,
                load: float = 0.6, include_llm: bool = True,
                pool: Optional[Sequence[Job]] = None,
                seed: int = 0) -> List[ChurnJob]:
    """Sample a churn trace from the Table-4 pool (plus the LLM decode jobs).

    `n_initial` jobs are present at t=0; `n_churn` more arrive uniformly
    over the first 70% of the horizon.  Lifetimes are exponential with mean
    `mean_lifetime_s`; a lifetime reaching past the horizon means the job
    never departs.  Every sampled tenancy gets a fresh unique job_id so
    re-picks of the same Table-4 row are distinct tenants.

    Each tenancy's Poisson arrival rate is `load` x its SLO-feasible
    steady capacity on a FULL device (`steady_capacity`).  At load ~0.6 a
    job needs well over half a device to keep up — a static union
    placement that thins every share to 1/k is physically unable to serve
    the demand, which is exactly the slack online re-placement harvests."""
    rng = np.random.default_rng(seed)
    candidates = list(pool) if pool is not None else list(PAPER_JOBS)
    if include_llm and pool is None:
        candidates = candidates + llm_serving_jobs()
    trace: List[ChurnJob] = []
    for k in range(n_initial + n_churn):
        base = candidates[int(rng.integers(len(candidates)))]
        job = dataclasses.replace(base, job_id=1000 + k)
        admit = 0.0 if k < n_initial else \
            float(rng.uniform(0.0, 0.7 * horizon_s))
        life = float(rng.exponential(mean_lifetime_s))
        depart = admit + life if admit + life < horizon_s else None
        trace.append(ChurnJob(job=job, admit_s=admit, depart_s=depart,
                              arrival_rate=load * steady_capacity(job)))
    trace.sort(key=lambda e: e.admit_s)
    return trace


# ---------------------------------------------------------------------------
# Scenario matrix traces: {steady, diurnal, flash} x {fixed, spot} cells.
# ---------------------------------------------------------------------------
def scenario_traffic_spec(traffic: str, *, horizon_s: float) -> Optional[dict]:
    """The per-kind traffic dict used by `scenario_trace`: one diurnal
    "day" is compressed onto the horizon (trough at t=0, peak mid-run);
    the flash crowd is a 3x step over ~7% of the horizon just past the
    midpoint.  Steady returns None (constant rate)."""
    if traffic == "steady":
        return None
    if traffic == "diurnal":
        return {"kind": "diurnal", "period_s": horizon_s,
                "peak_mult": 1.5, "trough_mult": 0.45, "phase_s": 0.0}
    if traffic == "flash":
        return {"kind": "flash", "at_s": 0.55 * horizon_s,
                "duration_s": 0.07 * horizon_s, "mult": 3.0}
    raise ValueError(f"unknown scenario traffic {traffic!r}")


def scenario_trace(traffic: str = "steady", *, horizon_s: float = 90.0,
                   n_jobs: int = 6, load: float = 0.05,
                   seed: int = 0) -> List[ChurnJob]:
    """One cell-trace of the scenario matrix: `n_jobs` light tenants (the
    mobile-net pool — textclassif/imdb is excluded because its base
    latency exceeds its own SLO, so no placement could ever attain it)
    whose Poisson rates follow the `traffic` kind.

    Most tenants span the whole horizon; one departs early and one arrives
    late, so the consolidate-vs-spread packing objective has empty devices
    to power-gate at trough and fresh admissions to place at peak.  Rates
    are `load` x the SLO-feasible capacity on a quarter slice —
    `steady_capacity` prices a LONE tenant, so `load` must also absorb
    the co-tenant interference of a packed device plus the flash-crowd
    3x peak while keeping >= 0.95 attainment (the BENCH_scenarios gate);
    0.05 holds that with margin on a 4-way packed P40."""
    rng = np.random.default_rng(seed)
    light_pool = [j for j in PAPER_JOBS
                  if j.dnn in ("mobilenet_v1_025", "mobilenet_v1_05")]
    spec = scenario_traffic_spec(traffic, horizon_s=horizon_s)
    trace: List[ChurnJob] = []
    for k in range(n_jobs):
        base = light_pool[int(rng.integers(len(light_pool)))]
        job = dataclasses.replace(base, job_id=3000 + k)
        admit, depart = 0.0, None
        if k == n_jobs - 2:
            depart = 0.40 * horizon_s     # frees capacity mid-run ...
        elif k == n_jobs - 1:
            admit = 0.50 * horizon_s      # ... which the late arrival can
            #                               take whole (under "spread") just
            #                               before the flash crowd lands
        trace.append(ChurnJob(
            job=job, admit_s=admit, depart_s=depart,
            arrival_rate=load * steady_capacity(job, share=0.25),
            traffic=spec))
    trace.sort(key=lambda e: e.admit_s)
    return trace
