"""Trace recording + counterfactual replay (the capacity-planning tool).

`ClusterEngine(record="name")` captures a run: the construction inputs
(jobs, churn tenancies, fleet, every engine knob), the
admission/migration/resize/drain event stream (`churn_log`), and the
achieved aggregate, all persisted into the profile store's ``traces``
section.  Because the simulator is deterministic given those inputs
(frozen dataclasses, fixed seeds, and a JSON round-trip that preserves
every float bit-exactly), `replay_run(trace)` under the unchanged policy
reproduces the original `report()` EXACTLY — the determinism contract the
replay test pins — and under a counterfactual policy it answers the
what-if questions a capacity planner asks of a recorded production
window:

    "baseline"       — the recorded policy, verbatim (determinism check)
    "uniform-mtl"    — uniform multi-tenancy instead of the recorded
                       hybrid knobs (paper's MT column, fleet-wide)
    "mig"            — the same tenancies on a MIG-partitioned fleet
                       (discrete hardware slices, resize-not-migrate)
    "fewer-devices"  — the recorded workload on 80% of the fleet

`replay_diff` runs a set of policies and tabulates them against the
recorded aggregate (`launch/report.py --replay` prints it).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving import device_model as dm
from repro_torch.serving.workload import ChurnJob, Job, Preemption

TRACE_SECTION = "traces"
TRACE_VERSION = 1
WHATIF_POLICIES = ("baseline", "uniform-mtl", "mig", "fewer-devices")


def _plain(obj):
    """Recursively coerce to JSON-serializable plain Python (numpy
    scalars included); floats survive a JSON round-trip bit-exactly."""
    if isinstance(obj, dict):
        return {str(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


# -- serialization ----------------------------------------------------------
def serialize_job(job: Job) -> dict:
    return _plain(dataclasses.asdict(job))


def deserialize_job(d: dict) -> Job:
    d = dict(d)
    po = d.pop("profile_override", None)
    return Job(**d, profile_override=(dm.JobProfile(**po)
                                      if po is not None else None))


def serialize_churn(e: ChurnJob) -> dict:
    return {"job": serialize_job(e.job), "admit_s": e.admit_s,
            "depart_s": e.depart_s, "arrival_rate": e.arrival_rate,
            "traffic": _plain(e.traffic)}


def deserialize_churn(d: dict) -> ChurnJob:
    return ChurnJob(job=deserialize_job(d["job"]),
                    admit_s=d["admit_s"], depart_s=d["depart_s"],
                    arrival_rate=d["arrival_rate"],
                    traffic=d.get("traffic"))


def serialize_spec(spec) -> dict:
    return {"device": _plain(dataclasses.asdict(spec.device)),
            "mesh_shape": (list(spec.mesh_shape)
                           if spec.mesh_shape is not None else None),
            "name": spec.name}


def deserialize_spec(d: dict):
    from repro_torch.serving.cluster import DeviceSpec
    return DeviceSpec(device=dm.Device(**d["device"]),
                      mesh_shape=(tuple(d["mesh_shape"])
                                  if d["mesh_shape"] is not None else None),
                      name=d["name"])


def serialize_init(*, jobs, churn, fleet, meta: Optional[dict] = None,
                   **kwargs) -> dict:
    """Capture `ClusterEngine.__init__`'s inputs verbatim (called before
    any munging).  `kwargs` are the plain engine knobs."""
    return {
        "jobs": [serialize_job(j) for j in (jobs or [])],
        "churn": [serialize_churn(e) for e in (churn or [])],
        "fleet": [serialize_spec(s) for s in fleet],
        "kwargs": _plain(kwargs),
        "meta": _plain(meta or {}),
    }


def trace_from_engine(engine, rep: dict, *, sim_time_limit: float,
                      max_steps: int) -> dict:
    """One recorded run: construction inputs + run parameters + the
    admission/migration/resize/drain event stream + the aggregate."""
    return {
        "version": TRACE_VERSION,
        "init": engine._record_init,
        "run": {"sim_time_limit": float(sim_time_limit),
                "max_steps": int(max_steps)},
        "events": [_plain(list(ev)) for ev in engine.churn_log],
        "event_count": len(engine.event_log),
        "aggregate": _plain(rep["aggregate"]),
    }


# -- store plumbing ---------------------------------------------------------
def save_trace(store, name: str, trace: dict) -> None:
    store.record_trace(name, trace)


def load_trace(store, name: str) -> dict:
    trace = store.get_trace(name)
    if trace is None:
        raise KeyError(f"no recorded trace {name!r} in {store.root}")
    return trace


# -- counterfactual re-drive ------------------------------------------------
def _fewer(fleet: List, frac: float = 0.8) -> List:
    return fleet[:max(1, int(round(frac * len(fleet))))]


def replay_run(trace: dict, *, policy: str = "baseline",
               profile_store=None, vectorized: bool = False) -> dict:
    """Re-drive a recorded run under `policy` (one of WHATIF_POLICIES).

    "baseline" rebuilds the recorded scenario exactly — same entry point,
    same seeds, same fleet — and therefore reproduces the recorded
    `report()` bit for bit.  The counterfactuals perturb exactly one
    axis: the fleet size, the serving mode, or the sharing mechanism."""
    if policy not in WHATIF_POLICIES:
        raise ValueError(f"unknown what-if policy {policy!r}")
    from repro_torch.serving import cluster as cl
    init = trace["init"]
    meta = init.get("meta", {})
    kw = init.get("kwargs", {})
    jobs = [deserialize_job(j) for j in init["jobs"]]
    churn = [deserialize_churn(e) for e in init["churn"]]
    fleet = [deserialize_spec(s) for s in init["fleet"]]
    horizon = trace["run"]["sim_time_limit"]
    seed = kw.get("seed", 0)
    entry = meta.get("entry", "churn")
    mode = meta.get("mode", "hybrid")
    cpolicy = meta.get("policy")
    power_policy = kw.get("power_policy")
    prees = [Preemption(**p) for p in (kw.get("preemptions") or [])] or None
    if policy == "fewer-devices":
        fleet = _fewer(fleet)
        if prees:       # revocations of devices the cut removed are moot
            prees = [p for p in prees if p.device < len(fleet)] or None
    if policy == "uniform-mtl" and entry != "partition":
        mode = "MT"            # uniform multi-tenancy instead of hybrid
    if entry == "scenario":
        if policy == "mig":
            # the same scenario (traffic shapes + revocations travel with
            # the churn entries / preemption kwargs) on MIG-grid discrete
            # slices instead of MPS fractional shares
            return cl.run_partition_cluster(
                "het-mig", trace=churn, fleet=fleet, horizon_s=horizon,
                mode=mode, seed=seed, profile_store=profile_store,
                power_policy=power_policy, preemptions=prees,
                vectorized=vectorized)
        return cl.run_scenario_cluster(
            meta.get("traffic", "steady"), spot=bool(meta.get("spot")),
            power_policy=power_policy, fleet=fleet, horizon_s=horizon,
            max_mtl=int(meta.get("max_mtl", 2)), mode=mode, seed=seed,
            vectorized=vectorized, trace=churn, preemptions=prees)
    if policy == "mig" or entry == "partition":
        part_policy = ("het-mig" if policy == "mig"
                       else ("uniform" if policy == "uniform-mtl"
                             else (cpolicy or "het")))
        entries = churn if churn else [ChurnJob(job=j) for j in jobs]
        return cl.run_partition_cluster(
            part_policy, trace=entries, fleet=fleet, horizon_s=horizon,
            mode=mode, seed=seed, profile_store=profile_store,
            power_policy=power_policy, preemptions=prees,
            vectorized=vectorized)
    if entry == "paper":
        rates = kw.get("arrival_rates") or None
        if rates is not None:
            rates = {int(k): v for k, v in rates.items()}
        return cl.run_paper_cluster(
            mode, jobs=jobs, fleet=fleet, sim_time_limit=horizon,
            arrival_rates=rates, seed=seed, vectorized=vectorized)
    return cl.run_churn_cluster(
        cpolicy or "dynamic", trace=churn, fleet=fleet, horizon_s=horizon,
        mode=mode, seed=seed, profile_store=profile_store,
        power_policy=power_policy, preemptions=prees,
        vectorized=vectorized)


def _brief(agg: dict) -> dict:
    return {
        "devices": int(agg.get("devices", 0)),
        "goodput": float(agg.get("goodput", 0.0)),
        "throughput": float(agg.get("aggregate_throughput", 0.0)),
        "migrations": int(agg.get("migrations", 0)),
        "stall_s": float(agg.get("total_stall_s", 0.0)),
        "truncated": bool(agg.get("truncated", False)),
    }


def replay_diff(trace: dict, *,
                policies: Sequence[str] = WHATIF_POLICIES,
                profile_store=None, vectorized: bool = False) -> List[dict]:
    """Rows for the what-if diff table: the recorded aggregate first,
    then each counterfactual with its goodput relative to the record."""
    base = _brief(trace["aggregate"])
    rows = [{"policy": "recorded", **base, "goodput_vs_recorded": 1.0}]
    denom = base["goodput"]
    for p in policies:
        agg = replay_run(trace, policy=p, profile_store=profile_store,
                         vectorized=vectorized)["aggregate"]
        b = _brief(agg)
        rows.append({"policy": p, **b,
                     "goodput_vs_recorded":
                         (b["goodput"] / denom) if denom else float("nan")})
    return rows


def diff_table(rows: Sequence[dict]) -> str:
    """The replay diff as a markdown table."""
    cols = ("policy", "devices", "goodput", "throughput", "migrations",
            "stall_s", "goodput_vs_recorded", "truncated")
    lines = ["| " + " | ".join(cols) + " |",
             "|" + "|".join("---" for _ in cols) + "|"]
    for r in rows:
        cells = []
        for c in cols:
            v = r[c]
            cells.append(f"{v:.2f}" if isinstance(v, float) else str(v))
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)
