"""Cluster-scale multi-job serving (beyond the paper's single-job scope).

The paper evaluates DNNScaler one job at a time on one Tesla P40; the
ROADMAP north-star is a production fleet serving heavy multi-job traffic.
This module adds the missing layer:

  * `DeviceSpec` / `gpu_fleet` describe a heterogeneous fleet: whole GPUs
    (co-resident jobs each get an equal fractional share of the device,
    priced through `Device.share`) and TPU pod slices (each job gets a
    disjoint submesh via `tenancy.plan` — the pod-scale translation of
    co-location; the job's own MTL knob then subdivides its submesh).
  * `place` is a greedy SLO-aware packer: jobs are placed tightest-SLO
    first onto the least-loaded device whose residents (old and new) would
    still meet alpha*SLO at (bs=1, mtl=1) under the post-placement share;
    if no device qualifies, the least-loaded one is used anyway (the report
    surfaces the resulting violation instead of hiding it).
  * `ClusterEngine` runs one controller per job in lockstep simulated
    time: an event loop always advances the job with the smallest local
    clock, so co-scheduled jobs interleave exactly as a shared wall clock
    would order them.  Instance launch/kill stalls land on the owning
    job's timeline AND are accounted globally (`stall_time`).  Open-loop
    mode attaches a Poisson arrival process per job and accounts every
    request exactly once: completed, rejected (queue overflow), or left in
    the backlog at the horizon — the conservation invariant the cluster
    tests pin.
  * Online churn (`churn=` trace of `workload.ChurnJob`s): jobs admit and
    drain mid-run.  Admission re-runs the SLO-aware packer incrementally —
    and, when `anticipate=True`, scores candidate devices by each job's
    PREDICTED HYBRID STEADY STATE (the throughput-optimal (bs, mtl) under
    alpha*SLO on the post-admission share, from the shared `SurfaceLibrary`
    completion when it has history, else the analytic latency grid) rather
    than the (bs=1, mtl=1) point.  Any job whose device share changes pays
    an explicit migration cost: its current instances are killed and
    relaunched at the new share (charged to its own clock AND to global
    `stall_time`/`migration_stall_s`), plus a checkpoint-transfer term for
    TPU submesh moves (params must stream to the new submesh over DCN).
    When no device can host a new job, the packer attempts ONE relocation:
    moving the cheapest-to-migrate resident elsewhere to open room
    (migration-aware re-placement).  Draining frees share; the departing
    job stops receiving arrivals at its departure time but serves down its
    backlog first, so request conservation holds across every
    reconfiguration.  `static_union=True` disables all of this (placement
    fixed over the union of every tenancy that ever appears) — the
    baseline the churn example compares against.
  * Spatial partitioning (`partition="mps"|"mig"` — serving/partition.py):
    tenancies are placed into explicit compute/memory SLICES of a device
    instead of uniform time-shares.  Each job holds a granted share
    (heterogeneous across co-residents), priced through
    `device_model.part_latency_grid` — calibrated so uniform 1/k MPS
    grants reproduce the paper's MTL curves bit-identically.  The
    HybridScaler's third axis requests shares from a discrete ladder; the
    engine mediates grants against device headroom (`note_share_cap` /
    `note_share_grant`).  Churn re-placement RESIZES partitions (MPS
    set-percentage / MIG reconfigure, contexts stay alive — cheap,
    store-calibrated under a `resize|` key) instead of paying the
    kill+relaunch migration round; `partition_uniform=True` is the
    uniform-MTL baseline under the same pricing model, where every share
    change is still a full migration.  `run_partition_cluster` compares
    the two on a mixed small/large-DNN trace.
  * Lockstep fairness (`stall_cap_s`): a wall-clock compile or migration
    stall charged to a sub-millisecond simulated job clock starves that
    job in the lockstep loop until every peer catches up.  The cap bounds
    the clock charge per event (excess recorded in `stall_capped_s`,
    divergence tracked in `max_clock_skew_s`), keeping clock skew bounded
    in real-executor churn.
  * `run_paper_cluster` serves the 30 Table-4 jobs statically;
    `run_churn_cluster` is the churn scenario under {static-union, dynamic
    re-placement, dynamic + shared surface} policies.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.perf import autotune
from repro_torch.perf import cost_model as cost_model_mod
from repro_torch.serving import device_model as dm
from repro_torch.serving import partition as pt
from repro_torch.serving import tenancy
from repro_torch.serving.engine import Action, OpenLoopQueue, reconfig_stall
from repro_torch.serving.executor import SimExecutor
from repro_torch.serving.metrics import RunAccumulator, TailLatencyWindow
from repro_torch.serving.sim_state import SimState
from repro_torch.serving.workload import ChurnJob, Preemption, make_rate_fn

PLACEMENT_ALPHA = 0.85   # the scalers' hysteresis floor (paper alpha)
CKPT_TRANSFER_BPS = dm.DCN_BPS  # DCN bandwidth for TPU submesh checkpoint
#                          moves — the same 8 GB/s wire the KV-transfer
#                          fabric's DCN link class prices (device_model.DCN)
PART_RESIZE_S = 0.25     # modeling default for one partition resize (MPS
#                          set-percentage / MIG reconfigure): the contexts
#                          keep running — no kill+relaunch round — so it is
#                          an order of magnitude below the migration cost.
#                          Real executors calibrate it through the profile
#                          store exactly like migrations (key prefix
#                          "resize|").


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One fleet member: a whole accelerator or a TPU pod slice."""

    device: dm.Device
    mesh_shape: Optional[tuple] = None    # None = whole-GPU sharing
    name: str = ""

    def label(self, idx: int) -> str:
        return self.name or f"{self.device.name}/{idx}"


def gpu_fleet(n: int, device: dm.Device = dm.TESLA_P40) -> List[DeviceSpec]:
    return [DeviceSpec(device=device, name=f"{device.name}/{i}")
            for i in range(n)]


def _submesh_for(mesh_shape: tuple, n_jobs: int):
    """Smallest feasible split of the pod slice into >= n_jobs submeshes."""
    return tenancy.plan_at_least(mesh_shape, n_jobs)


def _job_share(spec: DeviceSpec, n_jobs: int) -> float:
    """Fraction of `spec` each of n_jobs co-resident jobs receives."""
    if n_jobs <= 1:
        return 1.0
    if spec.mesh_shape is not None:
        p = _submesh_for(spec.mesh_shape, n_jobs)
        # over-subscribed slice (more jobs than chips): time-multiplexed
        # equal share, mirroring the executor construction
        return p.share if p is not None else 1.0 / n_jobs
    return 1.0 / n_jobs


def _base_latency(spec: DeviceSpec, prof: dm.JobProfile, n_jobs: int) -> float:
    share = _job_share(spec, n_jobs)
    if share <= 0.0:
        return float("inf")
    return dm.batch_latency(spec.device, prof, 1, share=share)


def place(jobs: Sequence, fleet: Sequence[DeviceSpec], *,
          alpha: float = PLACEMENT_ALPHA) -> List[int]:
    """Greedy SLO-aware placement -> device index per job (same order)."""
    profs = [j.profile() for j in jobs]
    assign: List[Optional[int]] = [None] * len(jobs)
    residents: List[List[int]] = [[] for _ in fleet]

    def load(d: int) -> float:
        return sum(profs[j].occupancy for j in residents[d])

    for i in sorted(range(len(jobs)), key=lambda i: jobs[i].slo_s):
        feasible, fallback = [], []
        for d, spec in enumerate(fleet):
            k = len(residents[d]) + 1
            ok = all(_base_latency(spec, profs[j], k)
                     <= alpha * jobs[j].slo_s
                     for j in residents[d] + [i])
            (feasible if ok else fallback).append(d)
        pool = feasible or fallback
        best = min(pool, key=lambda d: (load(d), len(residents[d]), d))
        assign[i] = best
        residents[best].append(i)
    return assign


def _scalar_prop(field: str, cast) -> property:
    """Array-backed scalar attribute: `_JobState.<field>` reads and writes
    its slot in the engine's `SimState` arrays.  Reads return a plain
    Python scalar, so every downstream arithmetic expression is
    bit-identical to the old object-attribute code."""

    def fget(self):
        return cast(getattr(self.sim, field)[self.idx])

    def fset(self, v):
        getattr(self.sim, field)[self.idx] = v

    return property(fget, fset)


class _JobState:
    """Per-job serving state inside the cluster (one controller each).

    Scalar fields live in the engine's `SimState` structure-of-arrays
    (serving/sim_state.py) so the event loop, admission scan, and skew
    scan can query the whole fleet without walking Python objects; this
    object keeps the unvectorizable parts — controller, executor, tail
    window, accumulator, open-loop queue.  Semantics carried over:
    ``arrival_mark`` is where arrivals were last sampled up to, kept
    separate from the clock so stalls charged between steps (migrations)
    never swallow an arrival window; ``epoch`` bumps whenever the clock
    moves outside a step (the stale-heap guard); ``migration_modeled_s``
    is what the modeling defaults would have charged (vs the calibrated
    stalls actually charged); ``measured_migration_s`` is instrumented
    kill+relaunch wall time."""

    clock = _scalar_prop("clock", float)
    arrival_mark = _scalar_prop("arrival_mark", float)
    admit_s = _scalar_prop("admit_s", float)
    stall_time = _scalar_prop("stall_time", float)
    migration_stall_s = _scalar_prop("migration_stall_s", float)
    migration_modeled_s = _scalar_prop("migration_modeled_s", float)
    measured_migration_s = _scalar_prop("measured_migration_s", float)
    resize_stall_s = _scalar_prop("resize_stall_s", float)
    epoch = _scalar_prop("epoch", int)
    migrations = _scalar_prop("migrations", int)
    resizes = _scalar_prop("resizes", int)       # partition share changes
    submitted = _scalar_prop("submitted", int)   # closed-loop accounting
    completed = _scalar_prop("completed", int)
    active = _scalar_prop("active", bool)

    preempted = _scalar_prop("preempted", int)   # spot forced-kill flag

    def __init__(self, job, controller, executor, *, sim: SimState,
                 window: int, arrival_rate: Optional[float], max_queue: int,
                 seed: int, admit_s: float = 0.0,
                 depart_s: Optional[float] = None,
                 traffic: Optional[dict] = None):
        self.job = job
        self.controller = controller
        self.executor = executor
        self.window = TailLatencyWindow(window=window)
        self.acc = RunAccumulator()
        self.sim = sim
        self.idx = sim.add_job(admit_s=admit_s, depart_s=depart_s)
        self.prev = Action(bs=1, mtl=1)
        self.arrival_rate = arrival_rate
        # open-loop mechanics (arrival window, overflow, conservation) are
        # the shared OpenLoopQueue helper — same code path as
        # OpenLoopEngine.  `traffic` compiles a declarative time-varying
        # spec (diurnal / flash-crowd) into the rate_fn + integration
        # hints; constant rates keep the legacy exact single-point path.
        if arrival_rate is not None:
            rate_fn, piecewise_s, step_breaks = \
                make_rate_fn(arrival_rate, traffic)
            self.oq = OpenLoopQueue(rate_fn, max_queue=max_queue, seed=seed,
                                    piecewise_s=piecewise_s,
                                    step_breaks=step_breaks)
        else:
            self.oq = None

    @property
    def depart_s(self) -> Optional[float]:
        v = self.sim.depart_s[self.idx]
        return None if np.isinf(v) else float(v)

    @property
    def drained_at(self) -> Optional[float]:
        v = self.sim.drained_at[self.idx]
        return None if np.isnan(v) else float(v)

    @drained_at.setter
    def drained_at(self, v: float) -> None:
        self.sim.drained_at[self.idx] = v

    @property
    def queue(self) -> list:
        return self.oq.queue if self.oq is not None else []


class ClusterEngine:
    """Serve many jobs across a fleet, one controller each, in lockstep
    simulated time, with optional online churn (see module docstring)."""

    def __init__(self, jobs: Sequence, fleet: Sequence[DeviceSpec], *,
                 controller_factory: Callable, window: int = 200,
                 instance_launch_s: float = 2.0, instance_kill_s: float = 0.3,
                 arrival_rates: Optional[dict] = None, max_queue: int = 10_000,
                 seed: int = 0, churn: Optional[Sequence[ChurnJob]] = None,
                 static_union: bool = False, anticipate: bool = False,
                 surface_library=None, ckpt_bps: float = CKPT_TRANSFER_BPS,
                 executor_factory: Optional[Callable] = None,
                 profile_store=None, partition: Optional[str] = None,
                 partition_resize_s: float = PART_RESIZE_S,
                 partition_uniform: bool = False,
                 stall_cap_s: Optional[float] = None,
                 power_policy: Optional[str] = None,
                 preemptions: Optional[Sequence] = None,
                 record: Optional[str] = None, record_store=None,
                 record_meta: Optional[dict] = None,
                 retrain_every_rows: int = 8,
                 power_price_fn: Optional[Callable] = None):
        if partition not in (None, "mps", "mig"):
            raise ValueError(f"unknown partition kind {partition!r}")
        if power_policy not in (None, "pack", "spread"):
            raise ValueError(f"unknown power_policy {power_policy!r}")
        # trace recording (serving/replay.py): capture the construction
        # inputs verbatim BEFORE any munging, so `replay_run` can re-drive
        # the identical scenario under counterfactual policies
        self.record = record
        self._record_store = record_store
        if record is not None:
            from repro_torch.serving import replay as _replay
            self._record_init = _replay.serialize_init(
                jobs=jobs, churn=churn, fleet=fleet, window=window,
                instance_launch_s=instance_launch_s,
                instance_kill_s=instance_kill_s,
                arrival_rates=arrival_rates, max_queue=max_queue,
                seed=seed, static_union=static_union, anticipate=anticipate,
                ckpt_bps=ckpt_bps, partition=partition,
                partition_resize_s=partition_resize_s,
                partition_uniform=partition_uniform,
                stall_cap_s=stall_cap_s, power_policy=power_policy,
                preemptions=[dataclasses.asdict(p)
                             for p in (preemptions or [])],
                meta=record_meta)
        self.partition = partition
        self.partition_resize_s = partition_resize_s
        # the uniform-MTL baseline under the SAME spatial pricing model:
        # grants pinned at 1/k (uniform MPS is calibrated bit-identical to
        # MTL time-slicing), every share change charged as a full
        # kill+relaunch migration — isolating exactly what heterogeneous
        # shares + cheap resizes buy
        self.partition_uniform = partition_uniform
        # lockstep fairness: one wall-clock compile/migration stall charged
        # to a sub-millisecond simulated job clock makes that job starve in
        # the lockstep loop until every peer catches up.  `stall_cap_s`
        # bounds the skew: any single event charges at most this much to
        # the job's CLOCK (metrics still record the full cost via
        # `stall_capped_s`), so clock divergence stays bounded.
        self.stall_cap_s = stall_cap_s
        self.stall_capped_s = 0.0
        self.max_clock_skew_s = 0.0
        self.fleet = list(fleet)
        self.controller_factory = controller_factory
        self.window_size = window
        self.instance_launch_s = instance_launch_s
        self.instance_kill_s = instance_kill_s
        self.max_queue = max_queue
        self.seed = seed
        self.static_union = static_union
        self.anticipate = anticipate
        self.surface_library = surface_library
        self.ckpt_bps = ckpt_bps
        self.executor_factory = executor_factory
        self.profile_store = profile_store
        self.store_report: Optional[dict] = None
        self._arrival_rates = arrival_rates or {}
        self.cost_models: dict = {}       # device class -> fitted CostModel
        self._job_feats: dict = {}        # job_id -> ModelFeatures | None
        if profile_store is not None and surface_library is not None:
            # seed the shared surface from prior runs' persisted rows so a
            # recurring architecture in a FRESH process hits the
            # matrix-completion fast path (staleness- and LOO-gated)
            gen = autotune.generation()
            self.store_report = {"loaded": [], "evicted": []}
            for dc in sorted({spec.device.name for spec in fleet}):
                res = profile_store.load_surfaces(
                    surface_library, device_class=dc,
                    autotune_generation=gen)
                self.store_report["loaded"] += res["loaded"]
                self.store_report["evicted"] += res["evicted"]
        if profile_store is not None:
            # learned HLO cost models (perf/cost_model.py): the zero-probe
            # THIRD prediction tier.  Per device class, staleness-evicted
            # at load like surface rows; with an empty cost_model section
            # every prediction path below is byte-identical to before.
            gen = autotune.generation()
            for dc in sorted({spec.device.name for spec in fleet}):
                model = cost_model_mod.load_cost_model(
                    profile_store, dc, autotune_generation=gen)
                if model is not None:
                    self.cost_models[dc] = model
            if self.cost_models:
                if surface_library is not None:
                    # the shared library serves ONE prior: the model of
                    # the fleet's most common device class that has one
                    counts: dict = {}
                    for spec in fleet:
                        counts[spec.device.name] = \
                            counts.get(spec.device.name, 0) + 1
                    primary = max(self.cost_models,
                                  key=lambda dc: counts.get(dc, 0))
                    surface_library.set_cost_model(self.cost_models[primary])
                if self.store_report is not None:
                    self.store_report["cost_model"] = \
                        sorted(self.cost_models)

        # online cost-model retraining: every surface row persisted by a
        # drain or forced kill counts as FRESH training data; once a device
        # class accrues `retrain_every_rows` of them the class model is
        # refit from the store at drain time (train_cost_model itself
        # enforces its minimum-row floor, so a retrain never fires thin)
        self.retrain_every_rows = int(retrain_every_rows)
        self._fresh_rows: dict = {}       # device class -> rows since fit
        self.retrains: dict = {}          # device class -> refit count
        # carbon-aware power pricing: a time-varying $/J signal integrated
        # over each device's powered intervals (plus the dynamic joules
        # accrued while stepping).  None prices nothing and changes nothing.
        self.power_price_fn = power_price_fn
        self._price_ref: Optional[float] = None

        self.stall_time = 0.0
        self.compile_stall_s = 0.0
        self.migration_stall_s = 0.0
        self.migration_modeled_s = 0.0
        self.resizes = 0
        self.resize_stall_s = 0.0
        self.resize_equiv_migration_s = 0.0   # what full migrations would
        #                                       have cost the same events
        self._grant: dict = {}                # state idx -> partition share
        self._timeshared: set = set()         # devices whose tenant count
        #                                       outgrew the legal grid and
        #                                       fell back to 1/k time-
        #                                       multiplexing
        self.admissions = 0
        self.drains = 0
        self.migrations = 0
        self._rebuilds = 0
        # consolidate-vs-spread packing objective ("pack" power-gates empty
        # devices at trough, "spread" trades joules for tail latency)
        self.power_policy = power_policy
        # per-device energy decomposition: dynamic joules accumulate from
        # each step's dynamic_power_w; the idle floor is charged ONCE per
        # powered device over its powered interval (report() closes open
        # intervals at the makespan) — a power-gated device burns nothing
        self._dev_dynamic_j = [0.0] * len(fleet)
        self._dev_powered_s = [0.0] * len(fleet)
        self._dev_on_since: List[Optional[float]] = [None] * len(fleet)
        # closed powered intervals, kept so a time-varying power price can
        # be integrated over them in report(); the dynamic-cost ledger
        # accrues alongside dynamic joules at each step's own clock
        self._dev_intervals: List[list] = [[] for _ in fleet]
        self._dynamic_cost_usd = 0.0
        # spot revocations: (time, kind, Preemption) events consumed in
        # timestamp order interleaved with pending admissions
        self._cap_events: list = []
        for p in (preemptions or []):
            if not 0 <= p.device < len(fleet):
                raise ValueError(f"preemption targets unknown device "
                                 f"{p.device}")
            self._cap_events.append((p.at_s, 0, p))
            if p.restore_s is not None:
                self._cap_events.append((p.restore_s, 1, p))
        self._cap_events.sort(key=lambda e: (e[0], e[1]))
        self._cap_i = 0
        self._revoked: set = set()
        self._kill_at: dict = {}          # state idx -> forced-kill deadline
        self.preemptions_fired = 0
        self.preempt_evacuated = 0
        self.preempt_killed = 0
        self._horizon = float("inf")
        self._heap: Optional[list] = None
        self._steady_cache: dict = {}     # (job_id, d, k) -> analytic grid
        self._feas_cache: dict = {}       # feasibility-snapshot memo
        self.event_log: list = []         # (global time, job_id) pop order
        self.churn_log: list = []         # (time, kind, job_id, device)
        self._sim = SimState()            # per-job scalar state arrays
        self.truncated = False            # last run hit max_steps with
        #                                   simulated work still remaining
        self.steps_run = 0                # serving steps of the last run

        churn = sorted(churn or [], key=lambda e: e.admit_s)
        entries = ([ChurnJob(job=j) for j in jobs]
                   + [e for e in churn if e.admit_s <= 0.0])
        self._pending: List[ChurnJob] = [e for e in churn if e.admit_s > 0.0]
        self._pending_i = 0               # admission cursor (the pending
        #                                   list is consumed in admit order;
        #                                   no O(n^2) pop-from-front)
        if static_union:
            # the baseline: shares fixed over the union of every tenancy
            # that EVER appears — late arrivals hold their slice from t=0
            entries = entries + self._pending
            self._pending = []

        self.jobs = [e.job for e in entries]
        self.states: List[_JobState] = []
        self.placement: List[int] = []
        self.residents: List[List[int]] = [[] for _ in self.fleet]
        assign = self._initial_placement(entries)
        counts = [assign.count(d) for d in range(len(self.fleet))]
        for e, d in zip(entries, assign):
            share = None
            if self.partition is not None:
                share = self._legal_share(1.0 / counts[d])
            i = self._spawn(e, d, counts[d], share=share)
            self.residents[d].append(i)
            self._note_residency(d, self.states[i].admit_s)

    # -- partition helpers ----------------------------------------------------
    def _legal_share(self, share: float) -> float:
        """Snap a share onto the backend's legal grid (MIG profiles; MPS
        is continuous)."""
        if self.partition == "mig":
            return pt.snap("mig", share)
        return share

    def _min_grant(self) -> float:
        return pt.share_ladder(self.partition)[0]

    def _tenant_slice(self, share: float, tenants: int,
                      d: Optional[int] = None) -> pt.TenantSlice:
        # a time-multiplexed (over-subscribed) device shares memory paths
        # like MPS even under a MIG kind — no hardware isolation left
        iso = (1.0 if self.partition == "mig"
               and (d is None or d not in self._timeshared) else 0.0)
        k = round(1.0 / share) if share > 0 else 1
        # uniform 1/k grants carry the exact integer slowdown so partition
        # pricing is bit-identical to the MTL curves at equal share
        inv = float(k) if k >= 1 and share == 1.0 / k else 1.0 / share
        return pt.TenantSlice(share=share, mem_fraction=share,
                              inv_share=inv, tenants=tenants, isolation=iso)

    def _headroom(self, d: int) -> float:
        used = sum(self._grant.get(j, 0.0) for j in self.residents[d])
        return max(0.0, 1.0 - used)

    def partition_plan(self, d: int) -> pt.PartitionPlan:
        """The device's current spatial plan (report / legality checks).
        An over-subscribed device reports as time-multiplexed ("mps") —
        its 1/k grants are no longer spatial slices on the MIG grid."""
        k = len(self.residents[d])
        slices = tuple(self._tenant_slice(self._grant.get(j, 0.0), k, d)
                       for j in self.residents[d])
        kind = self.partition or "mps"
        if d in self._timeshared:
            kind = "mps"
        return pt.PartitionPlan(kind=kind, slices=slices)

    # -- construction helpers -----------------------------------------------
    def _initial_placement(self, entries: Sequence[ChurnJob]) -> List[int]:
        if not self.anticipate and self.power_policy is None:
            return place([e.job for e in entries], self.fleet)
        # anticipation-aware batch packing: same tightest-SLO-first greedy,
        # but each pick scores devices by the predicted steady state (or,
        # under a power_policy alone, by the consolidate/spread key)
        assign: List[Optional[int]] = [None] * len(entries)
        residents: List[List[int]] = [[] for _ in self.fleet]

        def rate_of(e: ChurnJob) -> Optional[float]:
            return (e.arrival_rate if e.arrival_rate is not None
                    else self._arrival_rates.get(e.job.job_id))

        order = sorted(range(len(entries)),
                       key=lambda i: entries[i].job.slo_s)
        for i in order:
            res_info = [[(entries[j].job, rate_of(entries[j])) for j in r]
                        for r in residents]
            d = self._choose_device(entries[i].job, rate_of(entries[i]),
                                    res_info, at=0.0)
            assign[i] = d
            residents[d].append(i)
        return assign

    def _executor_params(self, spec: DeviceSpec, k: int) -> tuple:
        """(device, mesh_shape, share) for one of k co-residents."""
        share = _job_share(spec, k)
        if spec.mesh_shape is not None:
            p = _submesh_for(spec.mesh_shape, k)
            if p is not None:
                return spec.device.share(p.share), p.replica_shape, p.share
            # more jobs than chips: no disjoint submesh exists, so the
            # slice is time-multiplexed — price an equal 1/k share
            # (pricing the FULL device here would serve every
            # over-subscribed job as sole owner and overstate the
            # aggregate k-fold)
            return spec.device.share(1.0 / k), spec.mesh_shape, 1.0 / k
        dev = spec.device.share(share) if share < 1.0 else spec.device
        return dev, None, share

    def _make_executor(self, job, d: int, k: int, seed: int,
                       part_share: Optional[float] = None):
        spec = self.fleet[d]
        if self.partition is not None and part_share is not None:
            # spatial partition: the tenant holds an explicit slice instead
            # of the uniform 1/k time-share
            ts = self._tenant_slice(part_share, k, d)
            if self.executor_factory is not None:
                ex = self.executor_factory(job, spec, part_share, None, seed)
                if hasattr(ex, "set_partition"):
                    ex.set_partition(ts)
            else:
                ex = SimExecutor(job.profile(), device=spec.device,
                                 seed=seed, partition=ts)
            try:
                ex._cluster_share = part_share
            except AttributeError:
                pass
            return ex
        dev, mesh, share = self._executor_params(spec, k)
        if self.executor_factory is not None:
            ex = self.executor_factory(job, spec, share, mesh, seed)
        else:
            prof = job.profile()
            if mesh is not None:
                ex = SimExecutor(prof, device=dev, mesh_shape=mesh,
                                 seed=seed, power_share=share)
            else:
                ex = SimExecutor(prof, device=dev, seed=seed,
                                 power_share=share)
        try:
            ex._cluster_share = share    # lets _reshare skip no-op rebuilds
            ex.power_share = share       # per-slice power attribution
        except AttributeError:           # exotic executors with __slots__
            pass
        return ex

    def _spawn(self, entry: ChurnJob, d: int, k: int,
               share: Optional[float] = None) -> int:
        """Create the per-job state on device d (with k co-residents)."""
        i = len(self.states)
        job = entry.job
        if share is not None:
            self._grant[i] = share
        serving_ex = self._make_executor(job, d, k, self.seed + i,
                                         part_share=share)
        profiling_ex = self._make_executor(job, d, k, self.seed + 1000 + i,
                                           part_share=share)
        if self.cost_models and self.surface_library is not None:
            # the controller's surface seeding keys the library by job_id;
            # features must be registered BEFORE the factory runs so the
            # zero-probe tier can answer its very first predict()
            self.surface_library.register_features(job.job_id,
                                                   self._job_features(job))
        controller = self.controller_factory(job, profiling_ex)
        if share is not None and hasattr(controller, "note_share_grant"):
            controller.note_share_grant(share)
        rate = (entry.arrival_rate if entry.arrival_rate is not None
                else self._arrival_rates.get(job.job_id))
        st = _JobState(job, controller, serving_ex, sim=self._sim,
                       window=self.window_size,
                       arrival_rate=rate, max_queue=self.max_queue,
                       seed=self.seed + 2000 + i, admit_s=entry.admit_s,
                       depart_s=entry.depart_s,
                       traffic=getattr(entry, "traffic", None))
        assert st.idx == i               # state index == SimState slot
        self.states.append(st)
        self.placement.append(d)
        if len(self.jobs) < len(self.states):
            self.jobs.append(job)
        return i

    # -- steady-state anticipation ------------------------------------------
    def _predicted_steady(self, job, d: int, k: int,
                          *, alpha: float = PLACEMENT_ALPHA
                          ) -> Optional[tuple]:
        """(throughput, bs, mtl) at the predicted hybrid steady state of
        `job` on device d with k residents: the throughput-optimal grid
        point whose predicted latency fits under alpha*SLO.  Prefers the
        cross-job SurfaceLibrary completion (re-anchored to this share's
        analytic base point); falls back to the analytic latency grid.
        None when even (bs=1, mtl=1) does not fit."""
        spec = self.fleet[d]
        dev, mesh, share = self._executor_params(spec, k)
        prof = job.profile()
        lib = self.surface_library
        bs_vals = np.asarray(lib.bs_values if lib is not None
                             else (1, 2, 4, 8, 16, 32, 64, 128))
        mtl_vals = np.asarray(lib.mtl_values if lib is not None
                              else tuple(range(1, 11)))
        n_mtl = len(mtl_vals)
        if mesh is not None:
            cap = tenancy.max_tenancy(mesh)
            mtl_vals = mtl_vals[mtl_vals <= max(cap, 1)]
            n_mtl = len(mtl_vals)
        surface = None
        if lib is not None:
            # library tier only: the model tier's surface is absolute (not
            # a normalized shape) and carries no support, so it must not
            # ride the re-anchoring below — it gets its own branch
            pred = lib.predict(job.job_id, allow_model=False)
            if pred is not None:
                est, support = pred
                est, support = est[:, :n_mtl], support[:, :n_mtl]
                # the completed row is a SHAPE (normalized by the job's
                # observed base at its old share); re-anchor it to the
                # candidate share's analytic (1, 1) point.  Unsupported
                # corners are extrapolation — never promise capacity there
                base = _base_latency(spec, prof, k)
                surface = np.where(support, est / est[0, 0] * base,
                                   np.inf)
        if surface is None and self.cost_models:
            # zero-probe tier: a never-before-seen job (no similar probed
            # history) is priced from its MODEL-PREDICTED profile through
            # the same mesh/share-aware laws, instead of the generic
            # profile fallback — placement SCORES only; the scaler's pins
            # and capacity promises still come from probed support
            model = self.cost_models.get(spec.device.name)
            feat = self._job_features(job) if model is not None else None
            if feat is not None:
                ck = ("cm", job.job_id, d, k)
                surface = self._steady_cache.get(ck)
                if surface is None:
                    pprof = model.predict_profile(
                        feat, name=f"{job.dnn}/{job.dataset}")
                    if mesh is not None:
                        ex = SimExecutor(pprof, device=dev, mesh_shape=mesh)
                        surface = ex.price_surface(bs_vals, mtl_vals)
                    else:
                        surface = dm.mt_latency_grid(dev, pprof, bs_vals,
                                                     mtl_vals)
                    self._steady_cache[ck] = surface
        if surface is None:
            # the analytic grid depends only on (job, device, k): memoize —
            # the relocation/rebalance scans re-price the same triple many
            # times per churn event
            ck = (job.job_id, d, k)
            surface = self._steady_cache.get(ck)
            if surface is None:
                if mesh is not None:
                    ex = SimExecutor(prof, device=dev, mesh_shape=mesh)
                    surface = ex.price_surface(bs_vals, mtl_vals)
                else:
                    surface = dm.mt_latency_grid(dev, prof, bs_vals,
                                                 mtl_vals)
                self._steady_cache[ck] = surface
        return dm.best_feasible_point(surface, bs_vals, mtl_vals,
                                      alpha * job.slo_s)

    def _modeled_migration_cost(self, st: _JobState,
                                spec: DeviceSpec) -> float:
        """Modeling-default seconds a share change costs `st`: its
        currently running instances are killed and relaunched at the new
        share in ONE parallel round (unlike the scaler's one-at-a-time MTL
        climbs, a share resize restarts every context at once — the 2.3 s
        default), plus a checkpoint-transfer term for TPU submesh moves —
        each instance's params stream to the new submesh over shared DCN
        bandwidth (8 GB/s default), so that term IS serial in bytes."""
        mtl = max(st.prev.mtl, 1)
        cost = self.instance_kill_s + self.instance_launch_s
        if spec.mesh_shape is not None:
            cost += st.job.profile().param_bytes * mtl / self.ckpt_bps
        return cost

    def _job_features(self, job):
        """Memoized cost-model features for one job (None is memoized too:
        a featureless architecture is asked exactly once)."""
        jid = job.job_id
        if jid not in self._job_feats:
            self._job_feats[jid] = cost_model_mod.features_for_job(job)
        return self._job_feats[jid]

    def _calibration_key(self, st: _JobState, spec: DeviceSpec) -> str:
        return f"{st.job.dnn}/{st.job.dataset}|{spec.device.name}"

    def _migration_cost(self, st: _JobState, spec: DeviceSpec) -> float:
        """Stall seconds charged for one share change of `st`: the profile
        store's calibrated percentile when enough instrumented
        kill+relaunch measurements exist for this (architecture, device
        class) — real executors only; a simulated executor has nothing the
        measurements describe — else the modeling defaults."""
        modeled = self._modeled_migration_cost(st, spec)
        if (self.profile_store is not None
                and hasattr(st.executor, "cache_stats")):
            cal = self.profile_store.migration_cost(
                self._calibration_key(st, spec))
            if cal is not None:
                return cal
        return modeled

    def _disruption_items(self, d: int) -> float:
        """Requests the residents of d would forgo while paying the
        migration stall a new admission forces on them."""
        total = 0.0
        for j in self.residents[d]:
            st = self.states[j]
            total += st.acc.throughput * self._migration_cost(st,
                                                              self.fleet[d])
        return total

    # -- carbon-aware power pricing -----------------------------------------
    def _power_price(self, at: float) -> float:
        return float(self.power_price_fn(max(at, 0.0)))

    def _price_reference(self) -> float:
        """Lazy mean of the price signal over the run horizon (a day when
        the horizon is open) — the flat level the pack deferral compares
        against."""
        if self._price_ref is None:
            end = self._horizon if np.isfinite(self._horizon) else 86_400.0
            ts = np.linspace(0.0, max(float(end), 1.0), 97)
            self._price_ref = float(np.mean([self._power_price(t)
                                             for t in ts]))
        return self._price_ref

    def _effective_power_policy(self, at: float) -> Optional[str]:
        """The packing objective in force at time `at`.  Under a
        time-varying power price, a `pack` fleet DEFERS consolidation
        while energy is cheap (price at or below half the signal's mean):
        power-gating an empty device saves little off-peak while the
        migrations it forces cost the same, so placements fall back to
        the neutral key until the price recovers.  Flat pricing
        (`power_price_fn=None`) and `spread` are untouched."""
        if (self.power_price_fn is not None and self.power_policy == "pack"
                and self._power_price(at) <= 0.5 * self._price_reference()):
            return None
        return self.power_policy

    def _choose_device(self, job, rate: Optional[float],
                       res_info: List[List[tuple]],
                       *, at: float, with_disruption: bool = False) -> int:
        """Incremental SLO-aware pick for one job over current residents
        (`res_info[d]` = [(job, arrival_rate or None), ...]).

        Feasibility is the same alpha*SLO check as `place`; among feasible
        devices, anticipation mode maximizes the cluster-level gain: the
        new job's predicted steady-state throughput — CAPPED at its
        arrival rate, a job never serves demand it doesn't have — over
        the remaining horizon, net of every co-resident's demand-capped
        steady-state loss from the share shrink and of the one-off
        migration disruption."""
        prof = job.profile()
        feasible, fallback = [], []
        for d, spec in enumerate(self.fleet):
            if d in self._revoked:
                continue                 # spot capacity gone: never place
            k = len(res_info[d]) + 1
            ok = (_base_latency(spec, prof, k) <= PLACEMENT_ALPHA * job.slo_s
                  and all(_base_latency(spec, rj.profile(), k)
                          <= PLACEMENT_ALPHA * rj.slo_s
                          for rj, _ in res_info[d]))
            (feasible if ok else fallback).append(d)
        pool = feasible or fallback
        if not pool:
            return -1                    # the whole fleet is revoked

        def load(d: int) -> float:
            return sum(rj.profile().occupancy for rj, _ in res_info[d])

        def pack(d: int) -> tuple:
            return pt.packing_key(self._effective_power_policy(at),
                                  occupied=bool(res_info[d]), fill=load(d))

        if not self.anticipate:
            return min(pool, key=lambda d: pack(d)
                       + (load(d), len(res_info[d]), d))
        remaining = max(self._horizon - at, 0.0) if np.isfinite(
            self._horizon) else 1.0
        remaining = max(remaining, 1e-9)

        served = self._served_rate

        def score(d: int) -> tuple:
            k0, k1 = len(res_info[d]), len(res_info[d]) + 1
            gain = served(job, rate, d, k1) * remaining
            loss = sum((served(rj, rr, d, k0) - served(rj, rr, d, k1))
                       * remaining for rj, rr in res_info[d])
            cost = self._disruption_items(d) if with_disruption else 0.0
            return ((-(gain - loss - cost),) + pack(d)
                    + (load(d), len(res_info[d]), d))

        return min(pool, key=score)

    def _served_rate(self, job, rate: Optional[float], d: int,
                     k: int) -> float:
        """Demand-capped predicted steady throughput: a job never serves
        requests it does not receive, so capacity beyond the arrival rate
        is worth nothing to the packer."""
        pred = self._predicted_steady(job, d, k)
        cap = pred[0] if pred is not None else 0.0
        return min(cap, rate) if rate is not None else cap

    def _resident_info(self) -> List[List[tuple]]:
        return [[(self.states[j].job, self.states[j].arrival_rate)
                 for j in r] for r in self.residents]

    # -- churn: admission, drain, migration ---------------------------------
    def _capped(self, cost: float) -> float:
        """Lockstep-fairness cap: the clock charge for one stall event.
        The excess is recorded in `stall_capped_s`, never silently lost."""
        if self.stall_cap_s is None:
            return cost
        charged = min(cost, self.stall_cap_s)
        self.stall_capped_s += cost - charged
        return charged

    def _note_residency(self, d: int, t: float) -> None:
        """Track device d's powered interval for the idle-floor charge: a
        device powers ON when its first resident lands and OFF when its
        last one leaves (so "pack" placement power-gates the empties);
        `report()` closes any interval still open at the makespan.  Every
        residents[d] mutation calls this with the event time."""
        on = self._dev_on_since[d]
        if self.residents[d]:
            if on is None:
                self._dev_on_since[d] = t
        elif on is not None:
            self._dev_powered_s[d] += max(t - on, 0.0)
            self._dev_intervals[d].append((on, max(t, on)))
            self._dev_on_since[d] = None

    def _charge_migration(self, j: int, d: int, k: int, *, at: float,
                          kind: str,
                          part_share: Optional[float] = None) -> None:
        """One migration round for state j on device d (k co-residents):
        rebuild the executor at the new share, charge the stall to the
        job's clock and the global counters, reset its tail window, and
        let the controller re-seed its search."""
        st = self.states[j]
        spec = self.fleet[d]
        # cost resolves BEFORE this round's own measurement lands in the
        # store: calibration always reflects prior rounds only
        cost = self._migration_cost(st, spec)
        modeled = self._modeled_migration_cost(st, spec)
        self._rebuilds += 1
        seed = self.seed + 3000 + self._rebuilds
        if hasattr(st.executor, "cache_stats"):
            # real executor: instrument the actual kill + relaunch +
            # recompile round and feed the migration calibration
            kill_s = (st.executor.shutdown()
                      if hasattr(st.executor, "shutdown") else 0.0)
            t0 = time.perf_counter()
            st.executor = self._make_executor(st.job, d, k, seed,
                                              part_share=part_share)
            build_s = time.perf_counter() - t0
            warm_s = (st.executor.warmup(st.prev.bs, st.prev.mtl)
                      if hasattr(st.executor, "warmup") else 0.0)
            measured = kill_s + build_s + warm_s
            st.measured_migration_s += measured
            if self.profile_store is not None:
                self.profile_store.record_migration(
                    self._calibration_key(st, spec), measured)
        else:
            st.executor = self._make_executor(st.job, d, k, seed,
                                              part_share=part_share)
        st.migration_modeled_s += modeled
        self.migration_modeled_s += modeled
        charged = self._capped(cost)
        st.clock += charged
        st.epoch += 1
        st.stall_time += charged
        st.migration_stall_s += charged
        st.migrations += 1
        st.acc.total_time += charged
        self.stall_time += charged
        self.migration_stall_s += charged
        self.migrations += 1
        st.window.reset()              # the latency surface just changed
        if hasattr(st.controller, "note_capacity_change"):
            st.controller.note_capacity_change(st.executor)
        self.churn_log.append((at, kind, st.job.job_id, spec.label(d)))
        if self._heap is not None:
            heapq.heappush(self._heap, (st.clock, j, st.epoch))

    # -- partition mode: resize instead of migrate ---------------------------
    def _resize_cost(self, st: _JobState, spec: DeviceSpec) -> float:
        """Stall seconds for one partition resize: an MPS set-percentage /
        MIG reconfigure keeps the serving contexts alive, so it is far
        below a kill+relaunch round.  Real executors calibrate it through
        the profile store under a `resize|` key, exactly like migrations."""
        if (self.profile_store is not None
                and hasattr(st.executor, "cache_stats")):
            cal = self.profile_store.migration_cost(
                "resize|" + self._calibration_key(st, spec))
            if cal is not None:
                return cal
        return self.partition_resize_s

    def _charge_resize(self, j: int, d: int, new_share: float, *, at: float,
                       kind: str = "resize",
                       tenant_change: bool = False) -> None:
        """Move state j's partition grant to `new_share` on its device:
        update the executor's slice in place (no relaunch), charge the
        cheap resize stall, and record what a full migration WOULD have
        cost the same event (`resize_equiv_migration_s` — the comparison
        the partition example pins)."""
        st = self.states[j]
        spec = self.fleet[d]
        as_migration = self.partition_uniform
        cost = (self._migration_cost(st, spec) if as_migration
                else self._resize_cost(st, spec))
        equiv = self._modeled_migration_cost(st, spec)
        self._grant[j] = new_share
        ts = self._tenant_slice(new_share, max(len(self.residents[d]), 1), d)
        if hasattr(st.executor, "cache_stats"):
            # real executor: instrument the reconfigure + re-warm round and
            # feed the resize calibration (PR 4 store, `resize|` prefix)
            t0 = time.perf_counter()
            if hasattr(st.executor, "set_partition"):
                st.executor.set_partition(ts)
            if hasattr(st.executor, "warmup"):
                st.executor.warmup(st.prev.bs, st.prev.mtl)
            measured = time.perf_counter() - t0
            if self.profile_store is not None:
                self.profile_store.record_migration(
                    "resize|" + self._calibration_key(st, spec), measured)
        elif hasattr(st.executor, "set_partition"):
            st.executor.set_partition(ts)
        charged = self._capped(cost)
        st.clock += charged
        st.epoch += 1
        st.stall_time += charged
        st.acc.total_time += charged
        self.stall_time += charged
        if as_migration:               # uniform baseline: a reshare IS a
            st.migration_stall_s += charged    # kill+relaunch round
            st.migrations += 1
            st.migration_modeled_s += equiv
            self.migration_stall_s += charged
            self.migrations += 1
            self.migration_modeled_s += equiv
        else:
            st.resize_stall_s += charged
            st.resizes += 1
            self.resize_stall_s += charged
            self.resizes += 1
            self.resize_equiv_migration_s += equiv
        st.window.reset()              # the latency surface just moved
        ctrl = st.controller
        if hasattr(ctrl, "note_share_grant"):
            ctrl.note_share_grant(new_share)
        if tenant_change and hasattr(ctrl, "note_capacity_change"):
            ctrl.note_capacity_change(st.executor)
        self.churn_log.append((at, kind, st.job.job_id, spec.label(d)))
        if self._heap is not None:
            heapq.heappush(self._heap, (st.clock, j, st.epoch))

    def _refresh_slices(self, d: int) -> None:
        """The device's tenant count changed: update every resident's
        slice interference term in place (shares untouched — an MPS
        repricing, not a reconfigure, so nothing is charged) and reset
        their tail windows."""
        k = max(len(self.residents[d]), 1)
        for j in self.residents[d]:
            st = self.states[j]
            ts = self._tenant_slice(self._grant.get(j, 1.0), k, d)
            if hasattr(st.executor, "set_partition"):
                st.executor.set_partition(ts)
            st.window.reset()

    def _maybe_grant_resize(self, i: int, requested: float,
                            at: float) -> None:
        """Mediate a scaler's share request: grant up to the device's
        headroom (snapped to the backend's legal grid), align the scaler
        with the actual grant, and charge the resize."""
        d = self.placement[i]
        st = self.states[i]
        cur = self._grant.get(i, 1.0)
        new = requested
        if requested > cur:
            new = min(requested, cur + self._headroom(d))
        new = self._legal_share(new)
        if new <= 0.0 or abs(new - cur) <= 1e-9:
            if hasattr(st.controller, "note_share_grant"):
                st.controller.note_share_grant(cur)
            return
        self._charge_resize(i, d, new, at=at, kind="resize",
                            tenant_change=False)

    @staticmethod
    def _struggling(st: _JobState) -> bool:
        """A resident that is NOT keeping up — growing backlog or a tail
        over its SLO — and therefore worth the stall of a bigger slice
        (the one gate shared by `_reshare(optional=True)`, the partition
        upsize, and the uniform-baseline drain path)."""
        behind = (st.oq is not None and st.oq.backlog
                  > 2 * max(st.prev.bs * st.prev.mtl, 1))
        return behind or st.window.p95 > st.job.slo_s

    def _partition_upsize(self, d: int, *, at: float) -> None:
        """A drain freed share: hand it to residents that are actually
        struggling (the same gate as `_reshare(optional=True)`); a
        keeping-up resident is left alone."""
        if d in self._timeshared:
            k = len(self.residents[d])
            if k * self._min_grant() <= 1.0 + pt.SHARE_TOL:
                # the tenant count fits the grid again: leave the
                # time-multiplex fallback, snapping every grant back
                # onto a legal slice
                self._timeshared.discard(d)
                for j in list(self.residents[d]):
                    legal = self._legal_share(self._grant.get(j, 0.0))
                    if abs(legal - self._grant.get(j, 0.0)) > 1e-9:
                        self._charge_resize(j, d, legal, at=at,
                                            kind="resize",
                                            tenant_change=True)
        needy = [j for j in self.residents[d]
                 if self._struggling(self.states[j])]
        if not needy:
            return
        extra = self._headroom(d) / len(needy)
        if extra <= 1e-9:
            return
        for j in needy:
            new = self._legal_share(
                min(1.0, self._grant.get(j, 0.0) + extra))
            if new > self._grant.get(j, 0.0) + 1e-9:
                self._charge_resize(j, d, new, at=at, kind="grow",
                                    tenant_change=False)

    def _partition_pick(self, job, at: float) -> Optional[tuple]:
        """Score every (unrevoked) device for a partition-mode insertion;
        returns (d, prospect, needs_shrink) for the best, or None when
        the whole fleet is revoked.  The score prefers feasible-without-
        shrink devices, then (under a power_policy) the consolidate or
        spread key, then most headroom / least load."""
        prof = job.profile()
        min_g = self._legal_share(self._min_grant())
        iso = 1.0 if self.partition == "mig" else 0.0
        scored = []
        for d, spec in enumerate(self.fleet):
            if d in self._revoked:
                continue                 # spot capacity gone: never place
            k = len(self.residents[d]) + 1
            head = self._headroom(d)
            target = self._legal_share(1.0 / k)     # uniform entitlement
            if self.partition_uniform:
                needs_shrink = False
                prospect = target
            elif self.power_policy is not None:
                # entitlement-fair admission (scenario cells): a newcomer
                # squeezed below its uniform 1/k slice by grown residents
                # reclaims up to the entitlement via cheap resizes — an
                # evacuee landing next to a 0.875-share hog must not be
                # pinned at the ladder floor for the rest of the run
                needs_shrink = head < target - 1e-9
                prospect = target if needs_shrink else \
                    self._legal_share(min(max(head if head < target
                                              else target, min_g), 1.0))
            else:
                needs_shrink = head < min_g - 1e-9
                prospect = min_g if needs_shrink else \
                    self._legal_share(min(max(head if head < target
                                              else target, min_g), 1.0))
            inv = 1.0 / prospect
            lat = dm.part_latency(spec.device, prof, 1, 1, inv_share=inv,
                                  tenants=k, isolation=iso)
            feasible = lat <= PLACEMENT_ALPHA * job.slo_s
            load = sum(self.states[j].job.profile().occupancy
                       for j in self.residents[d])
            pack = pt.packing_key(self._effective_power_policy(at),
                                  occupied=bool(self.residents[d]),
                                  fill=1.0 - head)
            scored.append(((not feasible, needs_shrink) + pack
                           + (-head, load, d),
                           d, prospect, needs_shrink))
        if not scored:
            return None
        _, d, prospect, needs_shrink = min(scored)
        return d, prospect, needs_shrink

    def _partition_reserve(self, d: int, prospect: float,
                           needs_shrink: bool, at: float) -> float:
        """Make room for one more tenant on device d (shrinks / uniform
        re-grants / time-multiplex fallback) and return the share the
        newcomer actually gets."""
        min_g = self._legal_share(self._min_grant())
        if self.partition_uniform:
            # every resident is re-granted its uniform 1/k slice; each
            # change is a full kill+relaunch migration (the baseline)
            knew = len(self.residents[d]) + 1
            prospect = self._legal_share(1.0 / knew)
            for j in list(self.residents[d]):
                if abs(self._grant.get(j, 0.0) - prospect) > 1e-9:
                    self._charge_resize(j, d, prospect, at=at,
                                        kind="migrate", tenant_change=True)
        elif needs_shrink:
            if self.partition == "mig":
                # discrete grid: residents step down one PROFILE at a
                # time, largest slice first, until the smallest profile
                # fits — a proportional scale would snap right back to the
                # rung a floor-sized resident already holds and free
                # nothing, silently oversubscribing the device
                progress = True
                while (self._headroom(d) < min_g - pt.SHARE_TOL
                       and progress):
                    progress = False
                    order = sorted(self.residents[d],
                                   key=lambda j: -self._grant.get(j, 0.0))
                    for j in order:
                        nxt = pt.mig_step_down(self._grant.get(j, 0.0))
                        if nxt is None:
                            continue
                        self._charge_resize(j, d, nxt, at=at,
                                            kind="shrink",
                                            tenant_change=True)
                        progress = True
                        if self._headroom(d) >= min_g - pt.SHARE_TOL:
                            break
            else:
                # free the newcomer's slice proportionally: its uniform
                # entitlement under a power_policy (see _partition_pick),
                # the ladder floor otherwise
                want = prospect if self.power_policy is not None else min_g
                used = sum(self._grant.get(j, 0.0)
                           for j in self.residents[d])
                scale = max(1.0 - want, 1e-9) / max(used, 1e-9)
                for j in list(self.residents[d]):
                    new = self._legal_share(self._grant.get(j, 0.0) * scale)
                    if new < self._grant.get(j, 0.0) - 1e-9:
                        self._charge_resize(j, d, new, at=at,
                                            kind="shrink",
                                            tenant_change=True)
            head = self._headroom(d)
            if head < min_g - pt.SHARE_TOL:
                # more tenants than the grid has slices: no legal spatial
                # plan exists, so the device falls back to time-multiplexed
                # equal shares — the same degradation the TPU submesh path
                # takes when jobs outnumber chips.  Every resident is
                # re-granted 1/k; `partition_plan` reports the device as
                # "mps" (time-shared) so legality reflects reality.
                knew = len(self.residents[d]) + 1
                eq = 1.0 / knew
                self._timeshared.add(d)
                for j in list(self.residents[d]):
                    if abs(self._grant.get(j, 0.0) - eq) > 1e-9:
                        self._charge_resize(j, d, eq, at=at,
                                            kind="shrink",
                                            tenant_change=True)
                prospect = eq
            else:
                prospect = self._legal_share(max(min(head, prospect),
                                                 min_g))
        return prospect

    def _admit_partition(self, entry: ChurnJob) -> int:
        """Partition-mode admission: the newcomer takes a slice out of the
        chosen device's HEADROOM; only when no device has a minimal slice
        free are co-residents shrunk — via cheap resizes, never the
        kill+relaunch migration round the uniform time-sharing path pays."""
        job = entry.job
        pick = self._partition_pick(job, entry.admit_s)
        if pick is None:
            raise RuntimeError("admission with every device revoked")
        d, prospect, needs_shrink = pick
        prospect = self._partition_reserve(d, prospect, needs_shrink,
                                           entry.admit_s)
        i = self._spawn(entry, d, len(self.residents[d]) + 1, share=prospect)
        self.residents[d].append(i)
        self._note_residency(d, entry.admit_s)
        self.admissions += 1
        self.churn_log.append((entry.admit_s, "admit", job.job_id,
                               self.fleet[d].label(d)))
        self._refresh_slices(d)
        return i

    def _reshare(self, d: int, *, at: float,
                 exclude: Optional[int] = None,
                 optional: bool = False) -> None:
        """Device d's resident count changed: rebuild every resident whose
        share moved, charging each the migration cost.

        `optional=True` (a drain freed share) gates each upgrade on need:
        a resident that is keeping up — no backlog growth, tail under the
        SLO — gains nothing from a bigger slice but would still pay the
        relaunch stall, so it keeps serving on its old share."""
        spec = self.fleet[d]
        k = len(self.residents[d])
        if k == 0:
            return
        _, _, new_share = self._executor_params(spec, k)
        for j in list(self.residents[d]):
            if j == exclude:
                continue
            st = self.states[j]
            old_share = getattr(st.executor, "_cluster_share", None)
            if old_share is not None and old_share == new_share:
                continue               # e.g. a 4->3 drain on a (4,4) slice
            if optional and not self._struggling(st):
                continue
            self._charge_migration(j, d, k, at=at, kind="migrate")

    def _best_relocation_for(self, job, rate: Optional[float], at: float,
                             direct_value: float) -> Optional[tuple]:
        """Migration-aware re-placement at admission: consider swapping
        ONE resident (victim v: home device dt -> destination d2) so the
        new job takes v's slot.  The swap leaves dt's resident count
        unchanged — v's old co-residents pay NO reshare — so the net value
        is the new job's served rate at dt, plus the victim's served-rate
        delta, minus what d2's residents lose to the extra tenant and the
        one-off migration stalls.  Returns (victim idx, d2, dt) when the
        best swap beats `direct_value` by a margin, else None."""
        remaining = max(self._horizon - at, 0.0)
        if not np.isfinite(remaining) or remaining <= 0.0:
            return None
        served = self._served_rate
        info = self._resident_info()
        best = None   # (value, victim idx, d2, dt)
        for dt, spec in enumerate(self.fleet):
            k_dt = len(self.residents[dt])
            if k_dt == 0 or dt in self._revoked:
                continue
            # everyone on dt (minus any one victim, plus the new job) keeps
            # the same count — feasibility only needs the new job's check
            if (_base_latency(spec, job.profile(), k_dt)
                    > PLACEMENT_ALPHA * job.slo_s):
                continue
            gain_new = served(job, rate, dt, k_dt)
            for j in self.residents[dt]:
                st = self.states[j]
                v_cur = served(st.job, st.arrival_rate, dt, k_dt)
                for d2, spec2 in enumerate(self.fleet):
                    if d2 == dt or d2 in self._revoked:
                        continue
                    k2 = len(self.residents[d2]) + 1
                    ok = (_base_latency(spec2, st.job.profile(), k2)
                          <= PLACEMENT_ALPHA * st.job.slo_s
                          and all(_base_latency(spec2, rj.profile(), k2)
                                  <= PLACEMENT_ALPHA * rj.slo_s
                                  for rj, _ in info[d2]))
                    if not ok:
                        continue
                    v_new = served(st.job, st.arrival_rate, d2, k2)
                    loss = sum((served(rj, rr, d2, k2 - 1)
                                - served(rj, rr, d2, k2))
                               for rj, rr in info[d2])
                    one_off = (st.acc.throughput
                               * self._migration_cost(st, spec2)
                               + self._disruption_items(d2))
                    value = ((gain_new + v_new - v_cur - loss) * remaining
                             - one_off)
                    if value > direct_value and (best is None
                                                 or value > best[0]):
                        best = (value, j, d2, dt)
        if best is None:
            return None
        return best[1], best[2], best[3]

    def _move(self, j: int, d2: int, *, at: float,
              reshare_origin: bool = True, kind: str = "move") -> None:
        """Relocate resident j to device d2, cascading share changes.

        `reshare_origin=False` is for admission swaps: the caller refills
        j's old slot immediately, so the origin's count never really
        changes — upsizing the survivors now would charge them a full
        migration stall that the admission reshare would undo one call
        later."""
        d = self.placement[j]
        self.residents[d].remove(j)
        self.residents[d2].append(j)
        self.placement[j] = d2
        self._note_residency(d, at)
        self._note_residency(d2, at)
        self._charge_migration(j, d2, len(self.residents[d2]), at=at,
                               kind=kind)
        if reshare_origin:
            # survivors MAY upsize (only if struggling)
            self._reshare(d, at=at, optional=True)
        # d2 residents MUST shrink — the device is now shared more ways
        self._reshare(d2, at=at, exclude=j)

    def _rebalance(self, at: float, *, max_moves: int = 2) -> None:
        """Drain-time re-placement: freed capacity is only worth something
        if a struggling job moves onto it.  Greedily executes up to
        `max_moves` single-job relocations while the best one's predicted
        net gain — the mover's demand-capped served-rate delta, plus what
        its old co-residents regain, minus what the destination's
        residents lose and every one-off migration stall — is positive."""
        if self.static_union:
            return
        remaining = max(self._horizon - at, 0.0)
        if remaining <= 0.0 or not np.isfinite(remaining):
            return
        served = self._served_rate
        for _ in range(max_moves):
            info = self._resident_info()
            best = None      # (net gain items, state idx, destination)
            for d in range(len(self.fleet)):
                if d in self._revoked:
                    continue     # doomed residents ride out their grace
                for j in list(self.residents[d]):
                    st = self.states[j]
                    k_d = len(self.residents[d])
                    cur = served(st.job, st.arrival_rate, d, k_d)
                    old_mates = [(rj, rr) for rj, rr in info[d]
                                 if rj is not st.job]
                    regain = sum(
                        (served(rj, rr, d, k_d - 1)
                         - served(rj, rr, d, k_d))
                        for rj, rr in old_mates)
                    for d2, spec2 in enumerate(self.fleet):
                        if d2 == d or d2 in self._revoked:
                            continue
                        k2 = len(self.residents[d2]) + 1
                        ok = (_base_latency(spec2, st.job.profile(), k2)
                              <= PLACEMENT_ALPHA * st.job.slo_s
                              and all(_base_latency(spec2, rj.profile(), k2)
                                      <= PLACEMENT_ALPHA * rj.slo_s
                                      for rj, _ in info[d2]))
                        if not ok:
                            continue
                        new = served(st.job, st.arrival_rate, d2, k2)
                        if new <= cur * 1.05:
                            continue     # hysteresis against move thrash
                        loss = sum(
                            (served(rj, rr, d2, k2 - 1)
                             - served(rj, rr, d2, k2))
                            for rj, rr in info[d2])
                        one_off = (st.acc.throughput
                                   * self._migration_cost(st, spec2)
                                   + self._disruption_items(d2))
                        net = ((new - cur + regain - loss) * remaining
                               - one_off)
                        if net > 0 and (best is None or net > best[0]):
                            best = (net, j, d2)
            if best is None:
                return
            self._move(best[1], best[2], at=at)

    def _admit(self, entry: ChurnJob) -> int:
        """Admit a churn arrival: incremental packing, with one
        migration-aware relocation considered whenever direct placement
        leaves the new job underserved (or infeasible); then charge
        co-residents their share change."""
        if self.partition is not None:
            return self._admit_partition(entry)
        job = entry.job
        rate = (entry.arrival_rate if entry.arrival_rate is not None
                else self._arrival_rates.get(job.job_id))
        info = self._resident_info()
        d = self._choose_device(job, rate, info, at=entry.admit_s,
                                with_disruption=True)
        if d < 0:
            raise RuntimeError("admission with every device revoked")
        if self.anticipate:
            k = len(self.residents[d]) + 1
            served = self._served_rate(job, rate, d, k)
            remaining = max(self._horizon - entry.admit_s, 0.0)
            underserved = (rate is not None and served < 0.95 * rate) or \
                (_base_latency(self.fleet[d], job.profile(), k)
                 > PLACEMENT_ALPHA * job.slo_s)
            if underserved and np.isfinite(remaining):
                loss = sum(
                    (self._served_rate(rj, rr, d, k - 1)
                     - self._served_rate(rj, rr, d, k))
                    for rj, rr in info[d])
                direct_value = ((served - loss) * remaining
                                - self._disruption_items(d))
                swap = self._best_relocation_for(job, rate, entry.admit_s,
                                                 direct_value)
                if swap is not None:
                    victim, d2, dt = swap
                    self._move(victim, d2, at=entry.admit_s,
                               reshare_origin=False)
                    d = dt
        i = self._spawn(entry, d, len(self.residents[d]) + 1)
        self.residents[d].append(i)
        self._note_residency(d, entry.admit_s)
        self.admissions += 1
        self.churn_log.append((entry.admit_s, "admit", job.job_id,
                               self.fleet[d].label(d)))
        self._reshare(d, at=entry.admit_s, exclude=i)
        return i

    def _maybe_drain(self, i: int) -> bool:
        """Drain i once its departure time passed AND its backlog is
        served (arrivals were already clipped at depart_s, so the backlog
        is finite); frees its share for the co-residents."""
        st = self.states[i]
        if st.depart_s is None or st.clock < st.depart_s:
            return False
        if st.oq is not None and st.oq.queue:
            return False
        st.active = False
        st.drained_at = st.clock
        st.epoch += 1
        d = self.placement[i]
        # the departing tenancy's probed surface row is history worth
        # keeping — persist it NOW, before the freed share triggers
        # reshare migrations that reset co-residents' rows
        self._persist_job_surface(i, d)
        if i in self.residents[d]:
            self.residents[d].remove(i)
        self._note_residency(d, st.clock)
        self._kill_at.pop(i, None)       # drained before its kill deadline
        self.drains += 1
        self.churn_log.append((st.clock, "drain", st.job.job_id,
                               self.fleet[d].label(d)))
        if d in self._revoked:
            # a dying device's survivors are doomed or evacuating — never
            # upsize or rebalance onto it
            return True
        if not self.static_union:
            if self.partition is not None:
                if self.partition_uniform:
                    # uniform baseline mirrors the legacy drain: strugglers
                    # MAY upsize to the new 1/k — paying a migration round
                    k = max(len(self.residents[d]), 1)
                    share = self._legal_share(1.0 / k)
                    for j in list(self.residents[d]):
                        if self._struggling(self.states[j]) and \
                                share > self._grant.get(j, 0.0) + 1e-9:
                            self._charge_resize(j, d, share, at=st.clock,
                                                kind="migrate",
                                                tenant_change=True)
                else:
                    # freed share goes to struggling residents via cheap
                    # resizes; the interference term relaxes for everyone
                    self._partition_upsize(d, at=st.clock)
                self._refresh_slices(d)
            else:
                self._reshare(d, at=st.clock, optional=True)
                self._rebalance(st.clock)
        return True

    # -- spot capacity: revocation, evacuation, forced kill -------------------
    def _process_due_events(self, sim_time_limit: float,
                            nxt_fn: Callable[[], float]) -> None:
        """Fire pending admissions AND capacity (spot revoke/restore)
        events due before the next step event, merged in timestamp order
        (a revocation at the same instant as an admission fires first, so
        the packer never lands the newcomer on capacity that just left).
        With no capacity events this reduces verbatim to the legacy
        admission loop — same order, same RNG draws."""
        while True:
            nxt = nxt_fn()
            ta = (self._pending[self._pending_i].admit_s
                  if self._pending_i < len(self._pending) else float("inf"))
            tc = (self._cap_events[self._cap_i][0]
                  if self._cap_i < len(self._cap_events) else float("inf"))
            t = min(ta, tc)
            if not (t <= min(nxt, sim_time_limit) and t < sim_time_limit):
                return
            if tc <= ta:
                ev = self._cap_events[self._cap_i]
                self._cap_i += 1
                self._fire_capacity_event(ev)
            else:
                i = self._admit(self._pending[self._pending_i])
                self._pending_i += 1
                if self._heap is not None:
                    st = self.states[i]
                    heapq.heappush(self._heap, (st.clock, i, st.epoch))

    def _fire_capacity_event(self, ev: tuple) -> None:
        """One capacity edge.  Revoke: the device leaves the placement
        pool and every resident is evacuated to surviving capacity (one
        migration round each); a resident with nowhere to go serves
        through the grace window on the doomed device and is force-killed
        at the deadline.  Restore: the device simply rejoins the pool."""
        t, kind, p = ev
        d = p.device
        if kind == 1:
            self._revoked.discard(d)
            self.churn_log.append((t, "restore", None,
                                   self.fleet[d].label(d)))
            return
        self._revoked.add(d)
        self.preemptions_fired += 1
        self.churn_log.append((t, "revoke", None, self.fleet[d].label(d)))
        deadline = t + p.grace_s
        for j in list(self.residents[d]):
            st = self.states[j]
            if not st.active:
                continue
            if self.partition is not None:
                self._evacuate_partition(j, d, at=t, deadline=deadline)
                continue
            dest = self._choose_device(st.job, st.arrival_rate,
                                       self._resident_info(), at=t)
            if dest < 0:
                self._doom(j, deadline)
            else:
                self._move(j, dest, at=t, reshare_origin=False,
                           kind="evict")
                self.preempt_evacuated += 1

    def _evacuate_partition(self, j: int, d: int, *, at: float,
                            deadline: float) -> None:
        """Partition-mode evacuation: re-run the partition packer for the
        displaced tenant (shrinking the destination's residents if it
        must), charge ONE migration round at the new slice."""
        st = self.states[j]
        pick = self._partition_pick(st.job, at)
        if pick is None:
            self._doom(j, deadline)
            return
        d2, prospect, needs_shrink = pick
        prospect = self._partition_reserve(d2, prospect, needs_shrink, at)
        self.residents[d].remove(j)
        self._grant.pop(j, None)
        self._note_residency(d, at)
        self.residents[d2].append(j)
        self.placement[j] = d2
        self._note_residency(d2, at)
        self._grant[j] = prospect
        self._charge_migration(j, d2, len(self.residents[d2]), at=at,
                               kind="evict", part_share=prospect)
        if hasattr(st.controller, "note_share_grant"):
            st.controller.note_share_grant(prospect)
        self._refresh_slices(d2)
        self.preempt_evacuated += 1

    def _doom(self, j: int, deadline: float) -> None:
        """No surviving device can host j: it keeps serving on the
        revoked device through the grace window — arrivals clipped at the
        deadline — and is force-killed when its clock reaches it (unless
        it drains its backlog first)."""
        cur = self._sim.depart_s[j]
        self._sim.depart_s[j] = min(float(cur), deadline)
        self._kill_at[j] = deadline

    def _force_kill(self, j: int, *, at: float) -> None:
        """Grace expired with backlog still outstanding: sample arrivals
        up to the clipped departure (so every request is COUNTED), reject
        the stranded queue wholesale, and retire the job.  Conservation —
        submitted == completed + rejected + backlog — survives the kill."""
        st = self.states[j]
        kill_t = max(at, st.clock)
        if st.oq is not None:
            st.oq.step(st.arrival_mark, kill_t, 0, arrival_end=st.depart_s)
            st.oq.rejected += len(st.oq.queue)
            st.oq.queue = []
        st.clock = kill_t
        st.arrival_mark = kill_t
        st.preempted = 1
        st.active = False
        st.drained_at = kill_t
        st.epoch += 1
        d = self.placement[j]
        self._persist_job_surface(j, d)
        if j in self.residents[d]:
            self.residents[d].remove(j)
        self._note_residency(d, kill_t)
        self._grant.pop(j, None)
        self._kill_at.pop(j, None)
        self.preempt_killed += 1
        self.churn_log.append((kill_t, "revoke-kill", st.job.job_id,
                               self.fleet[d].label(d)))

    # -- cross-run persistence ----------------------------------------------
    def _persist_job_surface(self, i: int, d: int) -> bool:
        """Persist state i's shared-surface row to the profile store under
        its (architecture-signature, device-class) key."""
        if self.profile_store is None or self.surface_library is None:
            return False
        st = self.states[i]
        key = getattr(st.controller, "surface_key", None)
        if key is None:
            return False
        # only wall-clock latencies depend on the tuned tiles; simulated
        # rows are exempt from the generation staleness gate on reload
        dc = self.fleet[d].device.name
        wrote = self.profile_store.persist_surface(
            self.surface_library, key,
            signature=f"{st.job.dnn}/{st.job.dataset}",
            device_class=dc,
            autotune_generation=autotune.generation(),
            tile_dependent=hasattr(st.executor, "cache_stats"))
        if wrote:
            self._fresh_rows[dc] = self._fresh_rows.get(dc, 0) + 1
            self._maybe_retrain(dc)
        return wrote

    def _maybe_retrain(self, dc: str) -> None:
        """Online cost-model retraining: once `retrain_every_rows` fresh
        surface rows accrued for a device class since its last fit, refit
        the class's learned HLO model from the store right here at drain
        time.  `train_cost_model` keeps its own minimum-row floor, so a
        refit never fires on thinner history than a cold fit would accept;
        a fit that comes back None (rows persisted but too few usable)
        leaves the fresh-row counter alone and retries at the next drain."""
        if self._fresh_rows.get(dc, 0) < self.retrain_every_rows:
            return
        device = next((spec.device for spec in self.fleet
                       if spec.device.name == dc), None)
        model = cost_model_mod.train_cost_model(
            self.profile_store, dc, device=device,
            autotune_generation=autotune.generation())
        if model is None:
            return
        cost_model_mod.save_cost_model(self.profile_store, model)
        self.cost_models[dc] = model
        self._fresh_rows[dc] = 0
        self.retrains[dc] = self.retrains.get(dc, 0) + 1
        if self.surface_library is not None:
            # same election as boot: the shared library serves the model
            # of the fleet's most common device class that has one
            counts: dict = {}
            for spec in self.fleet:
                counts[spec.device.name] = counts.get(spec.device.name,
                                                      0) + 1
            primary = max(self.cost_models,
                          key=lambda c: counts.get(c, 0))
            self.surface_library.set_cost_model(self.cost_models[primary])

    def _persist_profiles(self) -> None:
        """End of run: every still-resident tenancy's surface row joins the
        store (drained ones were persisted at drain time), then one atomic
        save writes surfaces + migration calibrations together."""
        if self.profile_store is None:
            return
        for i, (st, d) in enumerate(zip(self.states, self.placement)):
            if st.active:
                self._persist_job_surface(i, d)
        self.profile_store.save()

    # -- one serving step for one job ---------------------------------------
    def _step(self, st: _JobState, i: Optional[int] = None) -> None:
        if i is None:
            i = self.states.index(st)
        ctrl = st.controller
        if hasattr(ctrl, "set_slo"):
            ctrl.set_slo(st.job.slo_s)
        if self.partition is not None and hasattr(ctrl, "note_share_cap"):
            # the scaler's third axis may only request up to the device's
            # current headroom on top of its own grant
            d = self.placement[i]
            ctrl.note_share_cap(min(1.0, self._grant.get(i, 1.0)
                                    + self._headroom(d)))
        act = ctrl.action()
        if (self.partition is not None and act.share is not None
                and abs(act.share - self._grant.get(i, 1.0)) > 1e-9):
            self._maybe_grant_resize(i, float(act.share), at=st.clock)
            act = ctrl.action()          # re-read the grant-aligned action
        win_start = st.arrival_mark  # arrivals keep coming during any stall
        cost = reconfig_stall(st.prev, act, self.instance_launch_s,
                              self.instance_kill_s)
        if cost:
            charged = self._capped(cost)
            st.clock += charged
            st.stall_time += charged
            self.stall_time += charged
            st.acc.total_time += charged
        if (act.bs, act.mtl) != (st.prev.bs, st.prev.mtl):
            st.window.reset()            # re-measure the tail at the new knobs

        res = st.executor.run_step(act.bs, act.mtl)
        comp = res.get("compile_time", 0.0)
        if comp:                         # AOT compile = stall, like a launch
            comp = self._capped(comp)
            st.clock += comp
            st.acc.total_time += comp
            st.acc.compile_stall_s += comp
            self.compile_stall_s += comp
        if (self.profile_store is not None
                and res.get("partition_slowdown", 1.0) != 1.0
                and res.get("wall_step_time")):
            # real-executor capped-batch proxy: the measured interference
            # (raw wall vs slice-inflated step) feeds the store
            self.profile_store.record_interference(
                self._calibration_key(st, self.fleet[self.placement[i]]),
                self._grant.get(i, 1.0), res["wall_step_time"],
                res["step_time"])
        # per-device dynamic energy (the idle floor is charged per powered
        # interval in report(), never per co-resident step)
        dyn_j = res.get("dynamic_power_w", res["power_w"]) * res["step_time"]
        self._dev_dynamic_j[self.placement[i]] += dyn_j
        if self.power_price_fn is not None:
            self._dynamic_cost_usd += self._power_price(st.clock) * dyn_j
        t1 = st.clock + res["step_time"]
        slo = st.job.slo_s
        if st.oq is not None:            # open loop: queue + conservation
            # the arrival window spans the launch/kill/compile/migration
            # stall too — the outside world does not pause while instances
            # restart, and served latencies (t1 - ts) must include that
            # wait; a draining job's window is clipped at its departure
            served, lats = st.oq.step(win_start, t1, act.bs * act.mtl,
                                      arrival_end=st.depart_s)
            st.completed += len(served)
            st.acc.record_step(
                items=len(served), step_time=res["step_time"],
                power_w=res["power_w"], request_latencies=lats, slo=slo)
        else:                            # closed loop: every item completes
            st.submitted += res["items"]
            st.completed += res["items"]
            st.acc.record_step(
                items=res["items"], step_time=res["step_time"],
                power_w=res["power_w"],
                request_latencies=res["request_latencies"], slo=slo)
        # controllers observe SERVICE latency (see OpenLoopEngine's note)
        st.window.add_many(res["request_latencies"])
        st.acc.trace.append((t1, act.bs, act.mtl, st.window.p95,
                             res["throughput"], slo))
        ctrl.observe(st.window.p95, res)
        st.clock = t1
        st.arrival_mark = t1
        st.prev = act
        # snapshot SLO feasibility AT SERVE TIME: report() must describe
        # the share this job actually served under, not whoever lives on
        # its device at the horizon
        self._sim.feasible_at_serve[i] = 1 if self._feasible_now(i) else 0

    def _feasible_now(self, i: int) -> bool:
        """SLO feasibility of state i's CURRENT slice — the same (bs=1,
        mtl=1) pricing `report()` uses — memoized on (device, resident
        count, grant), which fully determines it."""
        d = self.placement[i]
        k = max(len(self.residents[d]) + (0 if i in self.residents[d]
                                          else 1), 1)
        st = self.states[i]
        if self.partition is not None and self._grant.get(i):
            ck = (i, d, k, self._grant[i], d in self._timeshared)
            v = self._feas_cache.get(ck)
            if v is None:
                ts = self._tenant_slice(self._grant[i], k, d)
                base = dm.part_latency(self.fleet[d].device,
                                       st.job.profile(), 1, 1,
                                       inv_share=ts.inv_share,
                                       tenants=ts.tenants,
                                       isolation=ts.isolation)
                v = bool(base <= st.job.slo_s)
                self._feas_cache[ck] = v
            return v
        ck = (i, d, k)
        v = self._feas_cache.get(ck)
        if v is None:
            base = _base_latency(self.fleet[d], st.job.profile(), k)
            v = bool(base <= st.job.slo_s)
            self._feas_cache[ck] = v
        return v

    def _admissions_due(self, nxt: float, sim_time_limit: float) -> bool:
        """Pending arrivals due before the next step event (cursor-based:
        the pending list is consumed in admit order, never popped)."""
        if self._pending_i >= len(self._pending):
            return False
        due = self._pending[self._pending_i].admit_s
        return due <= min(nxt, sim_time_limit) and due < sim_time_limit

    def _note_skew(self, st: _JobState, i: int) -> None:
        """Lockstep divergence: how far this job's clock ran ahead of the
        slowest active peer (a stall-inflated clock starves in the
        lockstep loop until everyone catches up — `stall_cap_s` bounds
        it).  Only a stall moves the clock by more than one serving step,
        so this runs only then; the min is one vectorized reduction over
        the state arrays, not a Python list rebuild."""
        other = self._sim.min_other_active_clock(i)
        if np.isfinite(other):
            self.max_clock_skew_s = max(self.max_clock_skew_s,
                                        st.clock - other)

    def _work_remaining(self, sim_time_limit: float) -> bool:
        """Any active job still short of the horizon, or any unadmitted
        arrival due before it — the condition that turns a max_steps exit
        into a TRUNCATED (silently partial) run."""
        n = len(self._sim)
        clocks = self._sim.clock[:n]
        if bool(np.any(self._sim.active[:n] & (clocks < sim_time_limit))):
            return True
        return (self._pending_i < len(self._pending)
                and self._pending[self._pending_i].admit_s < sim_time_limit)

    def run(self, *, sim_time_limit: float = 120.0,
            max_steps: int = 500_000) -> dict:
        self._horizon = sim_time_limit
        self._heap = [(st.clock, i, st.epoch)
                      for i, st in enumerate(self.states) if st.active]
        heapq.heapify(self._heap)
        heap = self._heap
        steps = 0
        while steps < max_steps:
            # admissions and capacity events due before the next step
            # event re-run the packer / fire the revocation
            self._process_due_events(
                sim_time_limit, lambda: heap[0][0] if heap else float("inf"))
            if not heap:
                break
            t, i, ep = heapq.heappop(heap)
            st = self.states[i]
            if not st.active or ep != st.epoch or t != st.clock:
                continue                 # stale entry (migrated or drained)
            if t >= sim_time_limit:
                continue                 # this job reached the horizon
            if i in self._kill_at and t >= self._kill_at[i] - 1e-12:
                self._force_kill(i, at=self._kill_at[i])
                continue                 # grace expired on the doomed job
            self.event_log.append((t, st.job.job_id))
            stalls_before = st.stall_time + st.acc.compile_stall_s
            self._step(st, i)
            steps += 1
            if st.stall_time + st.acc.compile_stall_s > stalls_before:
                self._note_skew(st, i)
            if self._maybe_drain(i):
                continue
            heapq.heappush(heap, (st.clock, i, st.epoch))
        self._heap = None
        self.steps_run = steps
        self.truncated = bool(steps >= max_steps
                              and self._work_remaining(sim_time_limit))
        self._persist_profiles()
        rep = self.report()
        self._record_run(rep, sim_time_limit=sim_time_limit,
                         max_steps=max_steps)
        return rep

    def _record_run(self, rep: dict, *, sim_time_limit: float,
                    max_steps: int) -> None:
        """Trace recording: persist the construction inputs, the
        admission/migration/resize/drain event stream, and the achieved
        aggregate into the profile store (serving/replay.py re-drives
        them under counterfactual policies)."""
        if self.record is None:
            return
        from repro_torch.serving import replay as _replay
        store = self._record_store or self.profile_store
        if store is None:
            from repro_torch.perf.profile_store import store_for
            store = store_for()
        trace = _replay.trace_from_engine(self, rep,
                                          sim_time_limit=sim_time_limit,
                                          max_steps=max_steps)
        _replay.save_trace(store, self.record, trace)

    def report(self) -> dict:
        per_job = []
        goodput_items = 0.0
        for i, (st, d) in enumerate(zip(self.states, self.placement)):
            s = st.acc.summary()
            # a job is SLO-feasible on its slice iff even (bs=1, mtl=1)
            # fits under the SLO there; infeasible jobs are served
            # best-effort and flagged, not hidden.  The flag is the
            # snapshot taken at the job's LAST SERVE — the share it
            # actually ran under — not a recomputation from whoever lives
            # on the device at the horizon; only a job that never served
            # falls back to the current-slice computation.
            snap = int(self._sim.feasible_at_serve[i])
            feasible_flag = bool(snap) if snap >= 0 else \
                self._feasible_now(i)
            goodput_items += st.completed * s["slo_attainment"]
            per_job.append({
                "job_id": st.job.job_id,
                "dnn": f"{st.job.dnn}/{st.job.dataset}",
                "device": self.fleet[d].label(d),
                "approach": getattr(st.controller, "approach",
                                    getattr(st.controller, "name", "?")),
                "bs": st.prev.bs, "mtl": st.prev.mtl,
                "slo_ms": float(st.job.slo_ms),
                "p95_ms": float(s["p95_s"]) * 1e3,
                "tail_p95_ms": float(st.acc.tail_p95()) * 1e3,
                "feasible": feasible_flag,
                "slo_attainment": float(s["slo_attainment"]),
                "throughput": float(s["throughput"]),
                "stall_s": float(st.stall_time),
                "active": bool(st.active),
                "admit_s": float(st.admit_s),
                "depart_s": (float(st.depart_s)
                             if st.depart_s is not None else None),
                "drained_at": (float(st.drained_at)
                               if st.drained_at is not None else None),
                "migrations": int(st.migrations),
                "migration_stall_s": float(st.migration_stall_s),
                "migration_modeled_s": float(st.migration_modeled_s),
                "share": (float(self._grant[i]) if i in self._grant
                          else None),
                "resizes": int(st.resizes),
                "resize_stall_s": float(st.resize_stall_s),
                "submitted": (st.oq.submitted if st.oq is not None
                              else st.submitted),
                "completed": st.completed,
                "rejected": st.oq.rejected if st.oq is not None else 0,
                "backlog": st.oq.backlog if st.oq is not None else 0,
                "preempted": int(st.preempted),
            })
        makespan = float(max((st.clock for st in self.states), default=0.0))
        completed = sum(st.completed for st in self.states)
        feasible = [r for r in per_job if r["feasible"]]
        conserved = all(r["submitted"] == r["completed"] + r["rejected"]
                        + r["backlog"] for r in per_job)
        # energy: dynamic joules accumulated per step + the idle floor over
        # each device's powered interval (intervals still open at the
        # makespan are closed HERE, without mutating engine state)
        powered_s = []
        for d in range(len(self.fleet)):
            s = self._dev_powered_s[d]
            on = self._dev_on_since[d]
            if on is not None:
                s += max(makespan - on, 0.0)
            powered_s.append(s)
        idle_j = sum(self.fleet[d].device.idle_w * powered_s[d]
                     for d in range(len(self.fleet)))
        dynamic_j = float(sum(self._dev_dynamic_j))
        energy_j = idle_j + dynamic_j
        # carbon-aware power cost: integrate the $/J signal over every
        # powered interval at each device's idle floor (trapezoid over the
        # closed intervals plus any still open at the makespan), and add
        # the dynamic-cost ledger accrued at each step's own clock
        power_cost = None
        if self.power_price_fn is not None:
            idle_cost = 0.0
            for d in range(len(self.fleet)):
                ivs = list(self._dev_intervals[d])
                on = self._dev_on_since[d]
                if on is not None:
                    ivs.append((on, max(makespan, on)))
                for t0, t1 in ivs:
                    if t1 <= t0:
                        continue
                    ts = np.linspace(t0, t1, 65)
                    ps = np.asarray([self._power_price(t) for t in ts])
                    trapezoid = getattr(np, "trapezoid", np.trapz)
                    idle_cost += float(trapezoid(ps, ts)) \
                        * self.fleet[d].device.idle_w
            power_cost = idle_cost + self._dynamic_cost_usd
        return {
            "per_job": per_job,
            "aggregate": {
                "jobs": len(self.states),
                "devices": len(self.fleet),
                "makespan_s": makespan,
                "aggregate_throughput":
                    completed / makespan if makespan else 0.0,
                "goodput":
                    goodput_items / makespan if makespan else 0.0,
                "total_stall_s": float(self.stall_time),
                "compile_stall_s": float(self.compile_stall_s),
                "migration_stall_s": float(self.migration_stall_s),
                "migration_modeled_stall_s": float(self.migration_modeled_s),
                "admissions": int(self.admissions),
                "drains": int(self.drains),
                "migrations": int(self.migrations),
                "partition": self.partition,
                "resizes": int(self.resizes),
                "resize_stall_s": float(self.resize_stall_s),
                "resize_equiv_migration_stall_s":
                    float(self.resize_equiv_migration_s),
                "stall_capped_s": float(self.stall_capped_s),
                "max_clock_skew_s": float(self.max_clock_skew_s),
                "power_policy": self.power_policy,
                "energy_j": float(energy_j),
                "idle_energy_j": float(idle_j),
                "dynamic_energy_j": dynamic_j,
                "device_powered_s": float(sum(powered_s)),
                "devices_powered":
                    int(sum(1 for s in powered_s if s > 0.0)),
                "joules_per_good_request":
                    (float(energy_j / goodput_items)
                     if goodput_items > 0 else None),
                "power_cost_usd": (float(power_cost)
                                   if power_cost is not None else None),
                "cost_per_good_request":
                    (float(power_cost / goodput_items)
                     if power_cost is not None and goodput_items > 0
                     else None),
                "cost_model_retrains": dict(self.retrains),
                "preemptions": int(self.preemptions_fired),
                "preempt_evacuated": int(self.preempt_evacuated),
                "preempt_killed": int(self.preempt_killed),
                "truncated": bool(self.truncated),
                "conserved": bool(conserved),
                "min_attainment":
                    min((r["slo_attainment"] for r in per_job), default=1.0),
                "feasible_jobs": len(feasible),
                "jobs_meeting_slo":
                    int(sum(r["tail_p95_ms"] <= r["slo_ms"]
                            for r in feasible)),
            },
        }


class VectorClusterEngine(ClusterEngine):
    """`ClusterEngine` whose event loop runs over the `SimState` arrays.

    Two regimes, chosen per run:

    * **exact** (default; any adaptive controller, churn, open loop,
      partitioning, or store coupling): the next event is the argmin over
      the active-clock array instead of a heap pop.  Ties break toward
      the lowest index — the same order the reference heap's
      ``(clock, idx, epoch)`` tuples give — and stale heap entries in the
      reference only ever delay admissions to a later loop iteration
      *within* the same event round, so the two loops produce the same
      event sequence, the same RNG draws, and bit-identical reports (the
      conformance tests pin this on the BENCH_cluster and BENCH_churn
      scenarios).
    * **bulk** (static-knob, mtl=1, closed-loop `SimExecutor` fleets with
      no churn/partition/store coupling — the 1000x1000 scale scenario):
      jobs never interact (no stalls, no migrations, no shared surface),
      so each advances to the horizon in chunked vectorized draws, with
      the WHOLE fleet priced in one `fleet_step_latency` call up front.
      Statistically equivalent to the reference (same latency law per
      step), not bit-identical (one RNG call per chunk instead of two per
      step); per-event artifacts nobody aggregates (`event_log`, per-step
      traces, tail windows) are skipped.
    """

    def run(self, *, sim_time_limit: float = 120.0,
            max_steps: int = 500_000) -> dict:
        self._horizon = sim_time_limit
        self._heap = None       # _charge_* heap pushes are no-ops: the
        #                         clock arrays are always current
        if self._bulk_eligible():
            rep = self._run_bulk(sim_time_limit=sim_time_limit,
                                 max_steps=max_steps)
            if rep is not None:
                return rep
        return self._run_exact(sim_time_limit=sim_time_limit,
                               max_steps=max_steps)

    # -- exact mode: the reference event order, argmin-driven ----------------
    def _run_exact(self, *, sim_time_limit: float, max_steps: int) -> dict:
        sim = self._sim
        steps = 0
        while steps < max_steps:
            self._process_due_events(sim_time_limit, sim.next_event_clock)
            i = sim.frontier()
            if i < 0:
                break
            st = self.states[i]
            t = st.clock
            if t >= sim_time_limit:
                # every remaining active clock is at the horizon, and any
                # pending arrival before it was admitted above — the
                # reference loop reaches the same state by draining its
                # heap entry by entry
                break
            if i in self._kill_at and t >= self._kill_at[i] - 1e-12:
                self._force_kill(i, at=self._kill_at[i])
                continue                 # grace expired on the doomed job
            self.event_log.append((t, st.job.job_id))
            stalls_before = st.stall_time + st.acc.compile_stall_s
            self._step(st, i)
            steps += 1
            if st.stall_time + st.acc.compile_stall_s > stalls_before:
                self._note_skew(st, i)
            self._maybe_drain(i)
        self.steps_run = steps
        self.truncated = bool(steps >= max_steps
                              and self._work_remaining(sim_time_limit))
        self._persist_profiles()
        rep = self.report()
        self._record_run(rep, sim_time_limit=sim_time_limit,
                         max_steps=max_steps)
        return rep

    # -- bulk mode: independent static jobs advance in chunks ----------------
    def _bulk_eligible(self) -> bool:
        """Bulk needs provably independent jobs: static knobs at mtl=1
        (no launch stalls, so clocks never couple through the skew/stall
        paths), closed loop, simulated executors on whole-device shares,
        no churn, no partitioning, and no store/surface coupling."""
        if (self.partition is not None
                or self._pending_i < len(self._pending)
                or self._cap_events
                or self.profile_store is not None
                or self.surface_library is not None
                or self.stall_cap_s is not None
                or not self.states):
            return False
        for st in self.states:
            ctrl = st.controller
            if getattr(ctrl, "name", "") != "static":
                return False
            if int(getattr(ctrl, "mtl", 0)) != 1:
                return False
            if st.oq is not None or st.depart_s is not None:
                return False
            ex = st.executor
            if (hasattr(ex, "cache_stats")      # wall-clock executor
                    or getattr(ex, "mesh_shape", None) is not None
                    or getattr(ex, "partition", None) is not None):
                return False
            if not st.active:
                return False
        return True

    # legacy per-job chunk loop kept as the reference implementation the
    # fleet-vectorized path is validated against (and as an escape hatch)
    bulk_use_loop = False

    def _run_bulk(self, *, sim_time_limit: float,
                  max_steps: int) -> Optional[dict]:
        sim = self._sim
        n = len(self.states)
        acts = [Action(bs=int(st.controller.bs), mtl=int(st.controller.mtl))
                for st in self.states]
        devices = [st.executor.device for st in self.states]
        profiles = [st.executor.profile for st in self.states]
        bs = np.asarray([a.bs for a in acts], np.float64)
        mtl = np.asarray([a.mtl for a in acts], np.float64)
        # the whole fleet priced in ONE vectorized call per event round
        # (bulk has exactly one round: knobs are static)
        means = dm.fleet_step_latency(devices, profiles, bs, mtl)
        # pre-flight: if the fleet's expected step count cannot fit the
        # budget, bulk would distribute the truncation differently than
        # the reference interleaving — run exact instead, which then
        # raises the `truncated` flag the honest way
        remaining = np.maximum(sim_time_limit - sim.clock[:n], 0.0)
        est = float(np.sum(remaining / np.maximum(means, 1e-12)))
        if not np.isfinite(est) or est > 0.9 * max_steps:
            return None
        if self.bulk_use_loop:
            steps_total = self._bulk_jobloop(acts, means, sim_time_limit,
                                             max_steps)
        else:
            steps_total = self._bulk_vector(acts, means, sim_time_limit,
                                            max_steps)
        self.steps_run = steps_total
        self.truncated = bool(steps_total >= max_steps
                              and self._work_remaining(sim_time_limit))
        self._persist_profiles()
        rep = self.report()
        self._record_run(rep, sim_time_limit=sim_time_limit,
                         max_steps=max_steps)
        return rep

    def _bulk_jobloop(self, acts, means, sim_time_limit: float,
                      max_steps: int) -> int:
        sim = self._sim
        steps_total = 0
        for i, st in enumerate(self.states):
            act, mean = acts[i], float(means[i])
            if hasattr(st.executor, "power_terms"):
                power_w, dyn_w = st.executor.power_terms(act.bs, act.mtl)
            else:
                power_w = dm.power(st.executor.device, st.executor.profile,
                                   act.bs, act.mtl)
                dyn_w = power_w - st.executor.device.idle_w
            items_per_step = act.bs * act.mtl
            r = min(items_per_step, 64)
            sampler = st.executor.sampler
            rng = sampler.rng
            sigma = sampler.sigma
            spike_p, spike_mult = sampler.spike_p, sampler.spike_mult
            clock = float(sim.clock[i])
            slo = st.job.slo_s
            job_steps = 0
            while clock < sim_time_limit and steps_total < max_steps:
                want = (sim_time_limit - clock) / mean
                n_est = min(int(want * 1.05) + 8, max_steps - steps_total)
                # the per-step latency law of LatencySampler.sample,
                # drawn for a whole chunk at once
                lats = mean * np.exp(rng.normal(0.0, sigma, n_est))
                lats[rng.random(n_est) < spike_p] *= spike_mult
                starts = clock + np.concatenate(
                    ([0.0], np.cumsum(lats[:-1])))
                # a step is served iff it STARTS before the horizon —
                # the reference's `t >= sim_time_limit` skip
                n_acc = int(np.searchsorted(starts, sim_time_limit,
                                            side="left"))
                all_accepted = n_acc == n_est
                lats = lats[:n_acc]
                if n_acc:
                    # request latencies: lognormal + spikes around each
                    # accepted step's sampled latency (run_step's law)
                    req = lats[:, None] * np.exp(
                        rng.normal(0.0, sigma, (n_acc, r)))
                    req[rng.random((n_acc, r)) < spike_p] *= spike_mult
                    busy = float(lats.sum())
                    st.acc.record_bulk(items=items_per_step * n_acc,
                                       busy_s=busy,
                                       energy_j=power_w * busy,
                                       request_latencies=req, slo=slo)
                    self._dev_dynamic_j[self.placement[i]] += dyn_w * busy
                    if self.power_price_fn is not None:
                        self._dynamic_cost_usd += \
                            self._power_price(clock) * dyn_w * busy
                    clock += busy
                    st.executor.clock += busy
                    job_steps += n_acc
                    steps_total += n_acc
                if not all_accepted:
                    break
            sim.clock[i] = clock
            sim.arrival_mark[i] = clock
            sim.submitted[i] += items_per_step * job_steps
            sim.completed[i] += items_per_step * job_steps
            st.prev = act
            sim.feasible_at_serve[i] = 1 if self._feasible_now(i) else 0
        return steps_total

    def _bulk_vector(self, acts, means, sim_time_limit: float,
                     max_steps: int) -> int:
        """The whole FLEET advances per round: one (jobs x chunk) draw
        replaces the per-job Python chunk loop (the >10k-device follow-up).
        Same latency law per step as `_bulk_jobloop`; statistically
        equivalent, not bit-identical — per-job sampler streams are
        replaced by one fleet-level stream (one generator call per round
        instead of four per job), and each job's request-latency block is
        a slice of one pooled draw.  The global `max_steps` budget is
        consumed in job order, matching the loop's truncation shape."""
        sim = self._sim
        n = len(self.states)
        means = np.asarray(means, np.float64)
        items_per_step = np.asarray([a.bs * a.mtl for a in acts], np.int64)

        def _terms(i, st):
            if hasattr(st.executor, "power_terms"):
                return st.executor.power_terms(acts[i].bs, acts[i].mtl)
            w = dm.power(st.executor.device, st.executor.profile,
                         acts[i].bs, acts[i].mtl)
            return w, w - st.executor.device.idle_w

        terms = [_terms(i, st) for i, st in enumerate(self.states)]
        power_w = np.asarray([t[0] for t in terms], np.float64)
        dyn_w = np.asarray([t[1] for t in terms], np.float64)
        sigma = np.asarray([st.executor.sampler.sigma
                            for st in self.states], np.float64)
        spike_p = np.asarray([st.executor.sampler.spike_p
                              for st in self.states], np.float64)
        spike_mult = np.asarray([st.executor.sampler.spike_mult
                                 for st in self.states], np.float64)
        slo = np.asarray([st.job.slo_s for st in self.states], np.float64)
        r = np.minimum(items_per_step, 64).astype(np.int64)
        rng = np.random.default_rng(self.seed ^ 0x5BD1E995)
        clock = sim.clock[:n].astype(np.float64).copy()
        job_steps = np.zeros(n, np.int64)
        steps_total = 0
        active = clock < sim_time_limit
        while active.any() and steps_total < max_steps:
            idx = np.flatnonzero(active)
            m = len(idx)
            want = (sim_time_limit - clock[idx]) / means[idx]
            n_est = np.minimum((want * 1.05).astype(np.int64) + 8,
                               max_steps - steps_total)
            k = int(n_est.max())
            lats = means[idx][:, None] * np.exp(
                rng.normal(0.0, 1.0, (m, k)) * sigma[idx][:, None])
            lats = np.where(rng.random((m, k)) < spike_p[idx][:, None],
                            lats * spike_mult[idx][:, None], lats)
            colmask = np.arange(k)[None, :] < n_est[:, None]
            starts = clock[idx][:, None] + np.cumsum(lats, axis=1) - lats
            # a step is served iff it STARTS before the horizon; starts are
            # monotone per row, so acceptance is a per-row prefix
            accept = (starts < sim_time_limit) & colmask
            n_acc = accept.sum(axis=1)
            budget = max_steps - steps_total
            cum = np.cumsum(n_acc)
            if cum[-1] > budget:          # clip in job order, like the loop
                j = int(np.argmax(cum > budget))
                n_acc[j] = budget - (int(cum[j]) - int(n_acc[j]))
                n_acc[j + 1:] = 0
            tot = int(n_acc.sum())
            if tot:
                rmax = int(r[idx].max())
                # one pooled request-latency draw; each job slices its rows
                # and its first r columns (run_step's lognormal + spikes)
                zreq = rng.normal(0.0, 1.0, (tot, rmax))
                ureq = rng.random((tot, rmax))
                row0 = 0
                for pos in range(m):
                    na = int(n_acc[pos])
                    if na == 0:
                        continue
                    i = int(idx[pos])
                    st = self.states[i]
                    li = lats[pos, :na]
                    ri = int(r[i])
                    req = li[:, None] * np.exp(
                        zreq[row0:row0 + na, :ri] * sigma[i])
                    req = np.where(ureq[row0:row0 + na, :ri] < spike_p[i],
                                   req * spike_mult[i], req)
                    busy = float(li.sum())
                    st.acc.record_bulk(items=int(items_per_step[i]) * na,
                                       busy_s=busy,
                                       energy_j=power_w[i] * busy,
                                       request_latencies=req, slo=slo[i])
                    self._dev_dynamic_j[self.placement[i]] += \
                        float(dyn_w[i]) * busy
                    if self.power_price_fn is not None:
                        self._dynamic_cost_usd += self._power_price(
                            float(clock[i])) * float(dyn_w[i]) * busy
                    clock[i] += busy
                    st.executor.clock += busy
                    job_steps[i] += na
                    row0 += na
                steps_total += tot
            # a job whose whole chunk was accepted may still owe steps
            # before the horizon; everyone else is done
            active[idx] = (n_acc == n_est) & (clock[idx] < sim_time_limit)
            if steps_total >= max_steps:
                break
        sim.clock[:n] = clock
        sim.arrival_mark[:n] = clock
        sim.submitted[:n] += items_per_step * job_steps
        sim.completed[:n] += items_per_step * job_steps
        for i, st in enumerate(self.states):
            st.prev = acts[i]
            sim.feasible_at_serve[i] = 1 if self._feasible_now(i) else 0
        return steps_total


# ---------------------------------------------------------------------------
# The first-class scenario: the paper's 30 jobs as one cluster workload.
# ---------------------------------------------------------------------------
def paper_controller_factory(mode: str = "auto", *, max_mtl: int = 10,
                             library_jobs: int = 8, surface=None,
                             share_ladder=None):
    """Factory of per-job controllers for `ClusterEngine`.

    mode: "auto" (the paper's B-or-MT pick), "hybrid", "B", "MT" — all via
    DNNScalerController — or "clipper".  The matrix-completion estimator is
    seeded with a shared library of 'historically profiled' jobs, exactly
    like the single-job launchers do.  `surface` optionally shares one
    `SurfaceLibrary` across every controller the factory makes: each
    controller's probes feed the jobs x knobs matrix (keyed by job_id,
    the convention `ClusterEngine._predicted_steady` queries), and new
    controllers seed their HybridScaler from its completion."""
    from repro_torch.core.controller import ClipperController, DNNScalerController
    from repro_torch.core.matrix_completion import LatencyEstimator
    from repro_torch.serving.workload import PAPER_JOBS

    mtls = list(range(1, max_mtl + 1))
    library = []
    for j in PAPER_JOBS[:library_jobs]:
        # whole MTL curve priced in one vectorized call (mt_latency_grid)
        curve = dm.mt_latency_curve(dm.TESLA_P40, j.profile(), 1, mtls)
        library.append((j.job_id, dict(zip(mtls, curve))))

    def make(job, executor):
        if mode == "clipper":
            return ClipperController(job.slo_s)
        # on a TPU submesh the MTL knob cannot exceed the replica's chip
        # count — an estimate past it would send the scaler into the
        # infeasible (inf-latency) region and poison the job clock
        cap = max_mtl
        if getattr(executor, "mesh_shape", None) is not None:
            cap = max(1, min(cap, tenancy.max_tenancy(executor.mesh_shape)))
        est = LatencyEstimator(max_mtl=cap)
        for jid, row in library:
            if jid != job.job_id:    # never leak the served job's own
                est.add_library_row(row)   # ground-truth curve (held-out,
                                           # like build_library's exclude_id)
        return DNNScalerController(executor, job.slo_s, estimator=est,
                                   max_mtl=cap, mode=mode,
                                   surface_library=surface,
                                   surface_key=job.job_id,
                                   share_ladder=share_ladder)

    return make


def run_paper_cluster(mode: str = "auto", *, jobs: Optional[Sequence] = None,
                      fleet: Optional[Sequence[DeviceSpec]] = None,
                      n_devices: int = 12, sim_time_limit: float = 90.0,
                      arrival_rates: Optional[dict] = None,
                      seed: int = 0, vectorized: bool = False,
                      record: Optional[str] = None,
                      record_store=None) -> dict:
    """Serve the Table-4 jobs on a simulated fleet under one policy."""
    from repro_torch.serving.workload import PAPER_JOBS
    jobs = list(jobs) if jobs is not None else list(PAPER_JOBS)
    fleet = list(fleet) if fleet is not None else gpu_fleet(n_devices)
    cls = VectorClusterEngine if vectorized else ClusterEngine
    eng = cls(jobs, fleet,
              controller_factory=paper_controller_factory(mode),
              arrival_rates=arrival_rates, seed=seed,
              record=record, record_store=record_store,
              record_meta={"entry": "paper", "mode": mode})
    rep = eng.run(sim_time_limit=sim_time_limit)
    rep["aggregate"]["mode"] = mode
    return rep


CHURN_POLICIES = ("union", "dynamic", "surface")


def run_churn_cluster(policy: str = "surface", *,
                      trace: Optional[Sequence[ChurnJob]] = None,
                      fleet: Optional[Sequence[DeviceSpec]] = None,
                      n_devices: int = 5, horizon_s: float = 150.0,
                      mode: str = "hybrid", seed: int = 0,
                      trace_kwargs: Optional[dict] = None,
                      profile_store=None, vectorized: bool = False,
                      power_policy: Optional[str] = None,
                      preemptions: Optional[Sequence] = None,
                      record: Optional[str] = None,
                      record_store=None) -> dict:
    """The churn scenario under one placement policy.

    policy: "union"   — static placement over the union of every tenancy
                        that ever appears (the over-provisioned baseline);
            "dynamic" — online admission/draining with migration-aware
                        re-placement anticipating the analytic steady state;
            "surface" — dynamic plus the cross-job SurfaceLibrary (probed
                        points pooled across jobs; new admissions seed from
                        the soft-impute completion).

    `profile_store` (surface policy) reloads prior runs' persisted surface
    rows at construction and persists this run's rows at the end — the
    cross-run warm start."""
    if policy not in CHURN_POLICIES:
        raise ValueError(f"unknown churn policy {policy!r}")
    from repro_torch.core.matrix_completion import SurfaceLibrary
    from repro_torch.serving.workload import churn_trace
    if trace is None:
        trace = churn_trace(horizon_s=horizon_s, seed=seed,
                            **(trace_kwargs or {}))
    fleet = list(fleet) if fleet is not None else gpu_fleet(n_devices)
    lib = SurfaceLibrary() if policy == "surface" else None
    cls = VectorClusterEngine if vectorized else ClusterEngine
    eng = cls(
        [], fleet, churn=trace,
        controller_factory=paper_controller_factory(mode, surface=lib),
        static_union=(policy == "union"),
        anticipate=(policy != "union"),
        surface_library=lib, seed=seed,
        profile_store=(profile_store if policy == "surface" else None),
        power_policy=power_policy, preemptions=preemptions,
        record=record, record_store=record_store,
        record_meta={"entry": "churn", "policy": policy, "mode": mode})
    rep = eng.run(sim_time_limit=horizon_s)
    rep["aggregate"]["policy"] = policy
    rep["aggregate"]["mode"] = mode
    if eng.store_report is not None:
        rep["aggregate"]["store_rows_loaded"] = len(
            eng.store_report["loaded"])
        rep["aggregate"]["store_rows_evicted"] = len(
            eng.store_report["evicted"])
    return rep


PARTITION_POLICIES = ("uniform", "het", "het-mig")


def run_partition_cluster(policy: str = "het", *,
                          trace: Optional[Sequence[ChurnJob]] = None,
                          fleet: Optional[Sequence[DeviceSpec]] = None,
                          n_devices: int = 3, horizon_s: float = 120.0,
                          mode: str = "hybrid", seed: int = 0,
                          trace_kwargs: Optional[dict] = None,
                          profile_store=None, vectorized: bool = False,
                          power_policy: Optional[str] = None,
                          preemptions: Optional[Sequence] = None,
                          record: Optional[str] = None,
                          record_store=None) -> dict:
    """The spatial-partitioning scenario on a mixed small/large-DNN trace.

    policy: "uniform" — the existing dynamic churn engine: co-residents
                        each time-share an equal 1/k slice and every share
                        change is a kill+relaunch migration (the uniform
                        MTL baseline);
            "het"     — MPS-style spatial partitions: heterogeneous shares
                        per tenant, the HybridScaler's third (share) axis
                        active, and churn handled by cheap partition
                        RESIZES instead of migrations;
            "het-mig" — the same with MIG-grid discrete shares (hardware
                        isolation, shares snapped onto the profile grid).
    """
    if policy not in PARTITION_POLICIES:
        raise ValueError(f"unknown partition policy {policy!r}")
    from repro_torch.serving.workload import mixed_partition_trace
    if trace is None:
        trace = mixed_partition_trace(horizon_s=horizon_s, seed=seed,
                                      **(trace_kwargs or {}))
    fleet = list(fleet) if fleet is not None else gpu_fleet(n_devices)
    kind = {"uniform": "mps", "het": "mps", "het-mig": "mig"}[policy]
    uniform = policy == "uniform"
    ladder = None if uniform else pt.share_ladder(kind)
    cls = VectorClusterEngine if vectorized else ClusterEngine
    eng = cls(
        [], fleet, churn=trace,
        controller_factory=paper_controller_factory(mode,
                                                    share_ladder=ladder),
        partition=kind, partition_uniform=uniform, seed=seed,
        profile_store=profile_store,
        power_policy=power_policy, preemptions=preemptions,
        record=record, record_store=record_store,
        record_meta={"entry": "partition", "policy": policy, "mode": mode})
    rep = eng.run(sim_time_limit=horizon_s)
    rep["aggregate"]["policy"] = policy
    rep["aggregate"]["mode"] = mode
    return rep


SCENARIO_TRAFFICS = ("steady", "diurnal", "flash")


def spot_fleet(n: int, n_spot: int,
               device: dm.Device = dm.TESLA_P40) -> List[DeviceSpec]:
    """A fleet whose LAST `n_spot` devices are preemptible spot capacity
    (`workload.spot_revocation_trace` targets the spot-flagged members)."""
    out = []
    for i in range(n):
        dev = (dataclasses.replace(device, spot=True)
               if i >= n - n_spot else device)
        out.append(DeviceSpec(device=dev, name=f"{device.name}/{i}"))
    return out


def run_scenario_cluster(traffic: str = "steady", *,
                         spot: bool = False,
                         power_policy: Optional[str] = None,
                         fleet: Optional[Sequence[DeviceSpec]] = None,
                         n_devices: int = 4, n_spot: int = 1,
                         horizon_s: float = 150.0, max_mtl: int = 2,
                         mode: str = "hybrid", seed: int = 0,
                         vectorized: bool = False,
                         trace: Optional[Sequence[ChurnJob]] = None,
                         preemptions: Optional[Sequence] = None,
                         trace_kwargs: Optional[dict] = None,
                         record: Optional[str] = None,
                         record_store=None,
                         power_price_fn: Optional[Callable] = None) -> dict:
    """One cell of the scenario matrix: {steady, diurnal, flash-crowd}
    traffic x {fixed, spot} capacity x {None, pack, spread} packing —
    served by the MPS partition planner with the HybridScaler's share
    axis active.  Spot cells revoke each spot device once mid-run (with
    a restore), exercising evacuation under the traffic shape; the
    report's `energy_j` / `joules_per_good_request` expose what the
    packing objective buys at the diurnal trough.

    `power_price_fn` (time -> $/J) arms carbon-aware pricing: the report
    gains `power_cost_usd` / `cost_per_good_request` (the signal
    integrated over each device's powered intervals plus per-step dynamic
    joules), and a `pack` fleet defers power-gating consolidation while
    the price sits at or below half the signal's mean."""
    from repro_torch.serving.workload import (scenario_trace,
                                        spot_revocation_trace)
    if traffic not in SCENARIO_TRAFFICS:
        raise ValueError(f"unknown scenario traffic {traffic!r}")
    if fleet is None:
        fleet = (spot_fleet(n_devices, n_spot) if spot
                 else gpu_fleet(n_devices))
    else:
        fleet = list(fleet)
    if trace is None:
        trace = scenario_trace(traffic=traffic, horizon_s=horizon_s,
                               seed=seed, **(trace_kwargs or {}))
    if spot and preemptions is None:
        preemptions = spot_revocation_trace(fleet, horizon_s=horizon_s,
                                            seed=seed)
    cls = VectorClusterEngine if vectorized else ClusterEngine
    # max_mtl is capped well below the paper's 10: on a fractional MPS
    # slice the share axis replaces deep MTL climbs, and every avoided
    # instance launch is 2 s of adaptation stall the attainment gate
    # would otherwise charge to queued requests
    eng = cls(
        [], fleet, churn=trace,
        controller_factory=paper_controller_factory(
            mode, max_mtl=max_mtl, share_ladder=pt.share_ladder("mps")),
        partition="mps", seed=seed,
        power_policy=power_policy, preemptions=preemptions,
        power_price_fn=power_price_fn,
        record=record, record_store=record_store,
        record_meta={"entry": "scenario", "traffic": traffic,
                     "spot": bool(spot), "power_policy": power_policy,
                     "max_mtl": int(max_mtl), "mode": mode})
    rep = eng.run(sim_time_limit=horizon_s)
    agg = rep["aggregate"]
    agg["mode"] = mode
    agg["traffic"] = traffic
    agg["spot"] = bool(spot)
    return rep
