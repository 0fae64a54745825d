"""Disaggregated prefill/decode serving: prefill pool + KV-transfer fabric.

The continuous-batching engine (token_engine.py) prices prefill on the
SAME device as decode — time-sliced (decode stalls) or as a co-resident
spatial tenant (decode steps inflate).  Both couple two phases that sit
on opposite ends of the roofline: prefill is compute-dense (one big
matmul over the whole prompt), decode is weight-streaming bound (one
token per slot per step).
Disaggregation makes the fleet itself the third answer to the paper's
batching-vs-multi-tenancy dichotomy:

  * a ``PrefillPool`` of prefill-specialized tenancies on DEDICATED
    devices (``place_disagg_fleet`` carves them out of a cluster
    ``DeviceSpec`` fleet) absorbs every prompt;
  * a ``KVTransferFabric`` prices the finished KV cache's handoff
    (``kv_bytes_per_item x prefill_len``) over the per-device-class
    interconnect model (``device_model.Interconnect``: NVLink / PCIe /
    ICI / DCN bandwidth + a per-transfer latency floor, the DCN class
    reusing the TPU checkpoint-transfer constant);
  * a router assigns each request's prefill to the LEAST-LOADED pool
    member, then streams the finished KV into a free decode slot on the
    least-loaded decode device.

TTFT becomes queue + prefill + transfer; TPOT stays PURE decode — the
decode devices never see a prefill tenant, so their step latency is the
uncontended token-latency law.

Request conservation extends the cluster invariant with an in-flight
term: ``submitted == completed + rejected + backlog`` where backlog folds
in requests still prefilling or mid-KV-transfer — it holds at every exit,
including truncation and mid-transfer revocation of a pool member (the
revoked member's in-flight requests conserve into ``rejected``).

The ``HybridScaler``'s pool-ratio axis (``pool_ladder``) drives the
number of ACTIVE prefill members per decode device, demand-capped like
the share axis: the engine feeds it measured prefill-queue pressure and
the pool's busy fraction between decision windows.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving import device_model as dm
from repro_torch.serving.executor import SimExecutor
from repro_torch.serving.metrics import TailLatencyWindow
from repro_torch.serving.token_engine import (TokenRequest, _token_report,
                                        build_token_controller,
                                        memory_slot_cap,
                                        ragged_decode_trace)


# ---------------------------------------------------------------------------
# KV-transfer fabric
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class KVTransferFabric:
    """Prices KV-cache handoff over one interconnect class and keeps the
    accounting the bench pins against the analytic formula:

        transfer_s(n) = ic.latency_s + kv_bytes_per_token * n / ic.bw_bps
    """

    interconnect: dm.Interconnect
    kv_bytes_per_token: float
    transfers: int = 0
    bytes_moved: float = 0.0
    busy_s: float = 0.0

    def transfer_s(self, prefill_tokens: int) -> float:
        """The analytic transfer time for one request's KV (no state)."""
        return self.interconnect.transfer_s(
            self.kv_bytes_per_token * prefill_tokens)

    def charge(self, prefill_tokens: int) -> float:
        """Account one transfer and return its duration (seconds)."""
        t = self.transfer_s(prefill_tokens)
        self.transfers += 1
        self.bytes_moved += self.kv_bytes_per_token * prefill_tokens
        self.busy_s += t
        return t


def fabric_for(profile: dm.JobProfile, *, device: dm.Device = dm.TPU_V5E,
               kv_seq_budget: int = 1024,
               interconnect: Optional[dm.Interconnect] = None
               ) -> KVTransferFabric:
    """The fabric for one decode profile: per-token KV bytes derived from
    the profile's paged-KV reservation at its sequence budget, link class
    from the device registry (override with `interconnect`)."""
    ic = interconnect if interconnect is not None \
        else dm.interconnect_for(device.name)
    return KVTransferFabric(ic, profile.kv_bytes_per_item
                            / max(int(kv_seq_budget), 1))


# ---------------------------------------------------------------------------
# Prefill pool
# ---------------------------------------------------------------------------
class PrefillPool:
    """Prefill-specialized tenancies on dedicated devices.

    Each member is one device running nothing but prompt processing; the
    router (`assign`) picks the least-loaded member (earliest `free_at`,
    ties to the lowest id — deterministic).  A prompt of `n` tokens costs
    `n * prefill_s_per_token` member-seconds (sampled through the
    member's own noise stream), so pool time is token-proportional where
    the single-device modes charge the profile's flat budget-priced
    `prefill_ms` — the same mean on a trace whose prompts average the
    budget."""

    def __init__(self, profile: dm.JobProfile, *,
                 device: dm.Device = dm.TPU_V5E, n_members: int = 2,
                 kv_seq_budget: int = 1024, seed: int = 0):
        if n_members < 1:
            raise ValueError("a prefill pool needs at least one member")
        self.profile = profile
        self.device = device
        self.n_members = int(n_members)
        self.prefill_s_per_token = (profile.prefill_ms / 1e3
                                    / max(int(kv_seq_budget), 1))
        self.samplers = [dm.LatencySampler(seed=seed + 101 * m)
                         for m in range(self.n_members)]
        self.free_at = [0.0] * self.n_members
        self.busy_s = [0.0] * self.n_members
        self.prefills = [0] * self.n_members
        self.active = self.n_members       # pool-ratio axis resizes this
        self.dead: set = set()             # revoked members never assign

    # -- membership ---------------------------------------------------------
    def set_active(self, k: int) -> None:
        """Resize the ACTIVE membership (the pool-ratio axis): members
        beyond `k` stop receiving assignments but finish what they hold."""
        self.active = max(1, min(int(k), self.n_members))

    def kill(self, member: int) -> None:
        """Revoke one member (spot capacity loss): it never assigns again;
        the engine conserves its in-flight requests into `rejected`."""
        self.dead.add(int(member))

    def _candidates(self) -> List[int]:
        return [m for m in range(min(self.active, self.n_members))
                if m not in self.dead]

    # -- routing ------------------------------------------------------------
    def assign(self, clock: float, prefill_tokens: int) -> tuple:
        """Route one prompt to the least-loaded live member.  Returns
        (member, done_t); raises RuntimeError with every member dead."""
        cands = self._candidates()
        if not cands:
            raise RuntimeError("prefill pool has no live members")
        m = min(cands, key=lambda i: (self.free_at[i], i))
        start = max(clock, self.free_at[m])
        mean = self.prefill_s_per_token * max(int(prefill_tokens), 1)
        dur = float(self.samplers[m].sample(mean, n=1)[0])
        done = start + dur
        self.free_at[m] = done
        self.busy_s[m] += dur
        self.prefills[m] += 1
        return m, done

    # -- accounting ---------------------------------------------------------
    def energy_j(self, makespan: float) -> float:
        """Pool energy: the idle floor over the run for every member that
        ever powered on, plus the dynamic range over busy (compute-bound
        prefill runs the device near peak)."""
        dyn = self.device.peak_w - self.device.idle_w
        total = 0.0
        for m in range(self.n_members):
            if self.prefills[m]:
                total += self.device.idle_w * makespan \
                    + dyn * min(self.busy_s[m], makespan)
        return total

    def stats(self) -> dict:
        return {
            "members": self.n_members,
            "active": int(self.active),
            "dead": sorted(self.dead),
            "prefills": list(self.prefills),
            "busy_s": [float(b) for b in self.busy_s],
        }


def place_disagg_fleet(fleet: Sequence, n_prefill: int) -> tuple:
    """Split a cluster `DeviceSpec` fleet into (prefill_specs,
    decode_specs): the LAST `n_prefill` members become dedicated prefill
    devices (mirroring `spot_fleet`'s tail convention), the rest serve
    decode.  The ClusterEngine's placement idiom for disaggregation —
    prefill tenancies live on devices no decode tenant ever lands on."""
    fleet = list(fleet)
    if not 0 < n_prefill < len(fleet):
        raise ValueError("need at least one prefill AND one decode device")
    return fleet[len(fleet) - n_prefill:], fleet[:len(fleet) - n_prefill]


# ---------------------------------------------------------------------------
# The disaggregated engine
# ---------------------------------------------------------------------------
def run_disagg(trace: Sequence[TokenRequest], decode_executors, pool,
               fabric, *, max_slots: int = 32, mtl: int = 1,
               ttft_slo_s: float, tpot_slo_s: float,
               controller=None, pool_decision_steps: int = 200,
               max_queue: Optional[int] = None,
               revoke: Optional[tuple] = None,
               max_steps: int = 2_000_000) -> dict:
    """Serve `trace` disaggregated: every prompt goes to the prefill pool
    the moment it arrives, its finished KV streams over `fabric` into a
    free decode slot, and the decode device(s) run PURE token steps.

    `decode_executors` — one executor per decode device (a single
    executor is wrapped); with several, KV-ready requests activate on the
    least-loaded device (fewest live slots, ties to the lowest id) and
    devices advance in lockstep (earliest clock steps first).

    `revoke=(at_s, member)` kills one pool member mid-run: requests whose
    prefill or KV transfer is still in flight on it at `at_s` conserve
    into `rejected`; everything already decoding keeps its landed KV.

    A `controller` built with a `pool_ladder` drives the pool-ratio axis:
    every `pool_decision_steps` decode steps the engine feeds it the p95
    prefill+transfer wait and the pool's demand (busy device-seconds per
    second), and applies the resized active membership.
    """
    if not isinstance(decode_executors, (list, tuple)):
        decode_executors = [decode_executors]
    n_dev = len(decode_executors)
    trace = [dataclasses.replace(r) for r in trace]   # engines never share
    mem_cap = min(memory_slot_cap(ex, max_slots, mtl)
                  for ex in decode_executors)

    clocks = [0.0] * n_dev
    queue: deque = deque()
    in_flight: list = []   # [req, member, kv_done_t] — prefill OR transfer
    live = [[] for _ in range(n_dev)]     # per device: [req, tokens_left]
    idx = 0                               # next trace arrival
    completed = rejected = steps = 0
    tokens_out = 0
    energy_j = 0.0
    finished: list = []
    truncated = False
    revoke_at, revoke_member = (revoke if revoke is not None
                                else (None, None))
    revoked = False
    wait_samples: deque = deque(maxlen=256)   # prefill+transfer waits
    pool_mark_busy = 0.0
    pool_mark_t = 0.0
    window = TailLatencyWindow(window=200)

    def slot_cap() -> int:
        cap = max_slots
        if controller is not None:
            cap = min(cap, max(1, int(controller.action().bs)))
        return min(cap, mem_cap)

    def fire_revocation(now: float) -> int:
        """Kill the member; in-flight requests on it become `rejected`."""
        pool.kill(revoke_member)
        still, killed = [], 0
        for rec in in_flight:
            if rec[1] == revoke_member and rec[2] > revoke_at:
                killed += 1
            else:
                still.append(rec)
        in_flight[:] = still
        return killed

    while True:
        d = int(np.argmin(clocks))        # lockstep: earliest device steps
        clock = clocks[d]
        if revoke_at is not None and not revoked and clock >= revoke_at:
            rejected += fire_revocation(clock)
            revoked = True
        # 1. arrivals up to this device's clock enter the bounded queue
        while idx < len(trace) and trace[idx].arrival_s <= clock:
            if max_queue is not None and len(queue) >= max_queue:
                rejected += 1
            else:
                queue.append(trace[idx])
            idx += 1
        # 2. route every queued prompt to the pool NOW — prefill never
        #    waits for a decode slot (that is the whole point)
        while queue:
            req = queue.popleft()
            req.admit_s = clock
            m, p_done = pool.assign(clock, req.prefill_tokens)
            kv_done = p_done + fabric.charge(req.prefill_tokens)
            in_flight.append([req, m, kv_done])
        # 3. stream landed KV into free decode slots on THIS device
        cap = slot_cap()
        if in_flight and len(live[d]) < cap:
            in_flight.sort(key=lambda rec: rec[2])
            still = []
            for rec in in_flight:
                if rec[2] <= clock and len(live[d]) < cap:
                    req = rec[0]
                    # TTFT = queue + prefill + transfer (+ slot wait when
                    # the decode side is the bottleneck)
                    req.first_token_s = max(rec[2], clock)
                    live[d].append([req, req.decode_tokens])
                else:
                    still.append(rec)
            in_flight = still
        # 4. one PURE decode step — no prefill tenant ever lands here
        if live[d]:
            r = decode_executors[d].run_token_step(len(live[d]), mtl)
            lat = r["step_time"]
            clocks[d] = clock + lat
            steps += 1
            tokens_out += len(live[d]) * mtl
            energy_j += r["power_w"] * lat
            window.add_many(np.full(min(len(live[d]), 64), lat))
            if controller is not None:
                controller.observe(window.p95, {"items": len(live[d]),
                                                "step_time": lat})
            still = []
            for rec in live[d]:
                rec[1] -= 1
                rec[0].decode_time_s += lat
                if rec[1] == 0:           # evict-on-EOS: slot frees NOW
                    rec[0].finish_s = clocks[d]
                    completed += 1
                    finished.append(rec[0])
                else:
                    still.append(rec)
            live[d] = still
        elif any(live[e] for e in range(n_dev)):
            # this device is empty but a peer still decodes: catch up to
            # the fleet's next event so the argmin keeps rotating
            clocks[d] = min(min((c for e, c in enumerate(clocks)
                                 if live[e]), default=clock),
                            *[rec[2] for rec in in_flight]) \
                if in_flight else min(c for e, c in enumerate(clocks)
                                      if live[e])
            clocks[d] = max(clocks[d], clock + 1e-9)
        elif in_flight:                   # idle until the next KV lands
            nxt = min(rec[2] for rec in in_flight)
            if revoke_at is not None and not revoked and nxt > revoke_at:
                nxt = revoke_at
            for e in range(n_dev):
                clocks[e] = max(clocks[e], nxt)
            continue
        elif idx < len(trace):            # idle until the next arrival
            nxt = trace[idx].arrival_s
            if revoke_at is not None and not revoked and nxt > revoke_at:
                nxt = revoke_at
            for e in range(n_dev):
                clocks[e] = max(clocks[e], nxt)
            continue
        else:
            break
        # 5. pool-ratio axis: feed pressure + demand every decision window
        if controller is not None \
                and getattr(controller, "pool_ladder", None) is not None \
                and steps and steps % pool_decision_steps == 0:
            now = max(clocks)
            for rec in in_flight:
                wait_samples.append(max(rec[2] - rec[0].admit_s, 0.0))
            busy = sum(pool.busy_s)
            dt = max(now - pool_mark_t, 1e-9)
            demand = (busy - pool_mark_busy) / dt   # prefill dev-seconds/s
            pool_mark_busy, pool_mark_t = busy, now
            controller.note_pool_demand(demand / max(n_dev, 1))
            wait = (float(np.quantile(np.asarray(wait_samples), 0.95))
                    if wait_samples else 0.0)
            if controller.observe_pool(wait, ttft_slo_s):
                pool.set_active(
                    int(round(controller.pool_ratio * max(n_dev, 1))))
        if steps >= max_steps:
            truncated = True
            break

    makespan = max(max(clocks), 0.0)
    energy_j += pool.energy_j(makespan)
    backlog = (len(queue) + len(in_flight)
               + sum(len(live[e]) for e in range(n_dev)))
    rep = _token_report(
        "disagg", finished, clock=makespan, tokens_out=tokens_out,
        steps=steps, energy_j=energy_j, submitted=idx, completed=completed,
        rejected=rejected, backlog=backlog, ttft_slo_s=ttft_slo_s,
        tpot_slo_s=tpot_slo_s, truncated=truncated)
    rep.update({
        "n_decode_devices": n_dev,
        "in_transfer": len(in_flight),    # folded into backlog above
        "pool": pool.stats(),
        "fabric": {
            "interconnect": fabric.interconnect.name,
            "bw_bps": float(fabric.interconnect.bw_bps),
            "latency_s": float(fabric.interconnect.latency_s),
            "kv_bytes_per_token": float(fabric.kv_bytes_per_token),
            "transfers": int(fabric.transfers),
            "bytes_moved": float(fabric.bytes_moved),
            "busy_s": float(fabric.busy_s),
        },
    })
    return rep


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def run_disagg_serving(profile: dm.JobProfile, *,
                       device: dm.Device = dm.TPU_V5E, seed: int = 0,
                       trace: Optional[Sequence[TokenRequest]] = None,
                       n_requests: int = 400, rate_rps: float = 30.0,
                       prefill_mean: int = 2048,
                       n_prefill: int = 2, n_decode: int = 1,
                       kv_seq_budget: int = 1024,
                       interconnect: Optional[dm.Interconnect] = None,
                       max_slots: int = 32, mtl: int = 1,
                       ttft_slo_s: float = 2.0, tpot_slo_s: float = 0.25,
                       use_controller: bool = False,
                       pool_ladder: Optional[Sequence[float]] = None,
                       max_queue: Optional[int] = None,
                       revoke: Optional[tuple] = None) -> dict:
    """One decode job served disaggregated — the `serve.py
    --prefill-mode disagg` entry point.  Builds `n_decode` decode
    executors, an `n_prefill`-member PrefillPool on the same device
    class, and the fabric from the device's interconnect registry."""
    if trace is None:
        trace = ragged_decode_trace(n_requests, seed, rate_rps=rate_rps,
                                    prefill_mean=prefill_mean)
    decode_executors = [SimExecutor(profile, device, seed=seed + 13 * e)
                        for e in range(max(int(n_decode), 1))]
    pool = PrefillPool(profile, device=device, n_members=n_prefill,
                       kv_seq_budget=kv_seq_budget, seed=seed + 7)
    fabric = fabric_for(profile, device=device,
                        kv_seq_budget=kv_seq_budget,
                        interconnect=interconnect)
    controller = None
    if use_controller:
        controller = build_token_controller(
            decode_executors[0], tpot_slo_s, max_slots=max_slots, mtl=mtl,
            pool_ladder=pool_ladder)
    return run_disagg(trace, decode_executors, pool, fabric,
                      max_slots=max_slots, mtl=mtl, ttft_slo_s=ttft_slo_s,
                      tpot_slo_s=tpot_slo_s, controller=controller,
                      max_queue=max_queue, revoke=revoke)


def run_disagg_cluster(profiles: Sequence[dm.JobProfile], *,
                       device: dm.Device = dm.TPU_V5E, seed: int = 0,
                       **kwargs) -> dict:
    """Fleet-level disaggregated accounting: one disagg engine per decode
    job (job i with its own pool slice and seeded noise streams),
    aggregated with the token cluster's conservation convention."""
    jobs = [run_disagg_serving(p, device=device, seed=seed + 17 * i,
                               **kwargs)
            for i, p in enumerate(profiles)]
    tot = {k: int(sum(j[k] for j in jobs))
           for k in ("submitted", "completed", "rejected", "backlog",
                     "tokens_out", "steps")}
    makespan = max(j["makespan_s"] for j in jobs)
    tot.update({
        "jobs": jobs,
        "n_jobs": len(jobs),
        "makespan_s": makespan,
        "throughput_tokens_s": sum(j["throughput_tokens_s"] for j in jobs),
        "goodput_tokens_s": sum(j["goodput_tokens_s"] for j in jobs),
        "slo_attainment": (sum(j["slo_attainment"] * j["completed"]
                               for j in jobs)
                           / max(sum(j["completed"] for j in jobs), 1)),
        "conserved": (all(j["conserved"] for j in jobs)
                      and tot["submitted"] == tot["completed"]
                      + tot["rejected"] + tot["backlog"]),
        "truncated": any(j["truncated"] for j in jobs),
    })
    return tot
