"""Token-level continuous batching: the slot-based decode engine.

The paper's Batching axis treats `bs` as a per-REQUEST knob: a batch is
assembled, served for one fixed-shape step, and drained.  For LLM decode
jobs that shape is wasteful — a finished sequence holds its batch slot
until the whole bucketed step drains.  This module reinterprets `bs` as
*max live decode slots* and serves token by token:

  * admit-on-free-slot — an arriving request is inserted into the RUNNING
    decode batch the moment a slot frees, not at the next batch boundary;
  * evict-on-EOS — a sequence leaves the instant its last token is
    emitted, returning its slot (and its KV pages) immediately;
  * prefill is either time-sliced on the same tenant (decode stalls for
    `JobProfile.prefill_ms`) or priced as a co-resident prefill tenant
    (decode keeps stepping, inflated by the partition model's
    cross-tenant interference terms — the D-STACK-style spatio-temporal
    composition).

Per-token SLOs split a decode request's latency the way production LLM
serving does:

    TTFT  = first_token_s - arrival_s   (queue wait + prefill)
    TPOT  = decode_time_s / decode_tokens  (mean seconds per output token)

and *goodput* counts only the decode tokens of requests that met BOTH.

Pricing: a decode step with `s` live slots is a batch of `s` single-token
requests, so it is priced by the same calibrated laws as a `bs = s` batch
(`device_model.token_latency_grid`); the HybridScaler therefore drives
live slots with its existing `bs` axis — coordinate descent, pins, and
the share ladder all carry over unchanged.

The static bucketed baseline (`policy="static"`) is the same trace served
the old way — batches assembled to `bs`, fixed-shape decode at full `bs`
until the LONGEST member drains — so the continuous-vs-static goodput
ratio isolates exactly the slot-holding waste.

Request conservation (`submitted == completed + rejected + backlog`)
holds at every exit, mirroring the cluster engines' invariant.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.scaler import HybridScaler
from repro_torch.serving import device_model as dm
from repro_torch.serving.executor import SimExecutor
from repro_torch.serving.metrics import TailLatencyWindow
from repro_torch.serving.partition import TenantSlice


@dataclasses.dataclass
class TokenRequest:
    """One decode request: a prompt and a target number of output tokens."""
    req_id: int
    arrival_s: float
    prefill_tokens: int
    decode_tokens: int
    admit_s: float = -1.0          # left the queue (slot granted)
    first_token_s: float = -1.0    # prompt processed, first token out
    finish_s: float = -1.0         # EOS emitted
    decode_time_s: float = 0.0     # seconds spent inside decode steps

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.arrival_s

    @property
    def tpot_s(self) -> float:
        return self.decode_time_s / max(self.decode_tokens, 1)


def ragged_decode_trace(n_requests: int = 400, seed: int = 0, *,
                        rate_rps: float = 30.0, prefill_mean: int = 512,
                        decode_mean: int = 96, decode_sigma: float = 0.8,
                        max_decode: int = 1024) -> List[TokenRequest]:
    """Deterministic ragged-length decode trace: Poisson arrivals,
    uniform-ish prompts, LOGNORMAL output lengths (the raggedness that
    makes fixed-shape batching waste slots — max/mean per batch grows
    with `decode_sigma`)."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, n_requests))
    prefill = rng.integers(prefill_mean // 2, prefill_mean * 3 // 2 + 1,
                           n_requests)
    mu = math.log(decode_mean) - decode_sigma ** 2 / 2.0
    decode = np.clip(np.rint(np.exp(rng.normal(mu, decode_sigma,
                                               n_requests))),
                     1, max_decode).astype(int)
    return [TokenRequest(i, float(arrivals[i]), int(prefill[i]),
                         int(decode[i])) for i in range(n_requests)]


def memory_slot_cap(executor, max_slots: int, mtl: int = 1) -> int:
    """Largest live-slot count the executor's memory admission allows —
    the paged-KV budget (`kv_bytes_per_item`) applied to SLOTS, so a
    decode job cannot over-admit on memory.  At least 1 so the engine can
    always drain (a profile that cannot fit one slot raises instead)."""
    lo = max_slots
    while lo > 1 and not executor.fits(lo, mtl):
        lo -= 1
    if lo == 1 and not executor.fits(1, mtl):
        raise ValueError("profile does not fit a single decode slot")
    return lo


def build_token_controller(executor, tpot_slo_s: float, *,
                           max_slots: int = 64, mtl: int = 1,
                           share_ladder=None,
                           pool_ladder=None) -> HybridScaler:
    """HybridScaler over live slots: `bs` IS the slot cap, seeded from the
    priced token-latency surface so infeasible slot counts are pinned
    before a single over-SLO step is served.  With a `share_ladder` the
    scaler trades live slots against co-tenant device shares with the
    same coordinate-descent/pin machinery as whole-request serving; a
    `pool_ladder` arms the prefill-pool-ratio axis the disaggregated
    engine drives (see `serving.disagg.run_disagg`)."""
    scaler = HybridScaler(tpot_slo_s, primary="B", max_bs=max_slots,
                          max_mtl=mtl, share_ladder=share_ladder,
                          pool_ladder=pool_ladder)
    slots = [s for s in (1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 96, 128)
             if s <= max_slots]
    surface = np.stack([
        dm.token_latency_grid(executor.device, executor.profile, slots, [m])
        [:, 0] for m in range(1, mtl + 1)], axis=1)
    scaler.seed_surface(slots, list(range(1, mtl + 1)), surface)
    return scaler


# ---------------------------------------------------------------------------
# Continuous (slot-based) engine
# ---------------------------------------------------------------------------
def run_continuous(trace: Sequence[TokenRequest], executor, *,
                   max_slots: int = 32, mtl: int = 1,
                   ttft_slo_s: float, tpot_slo_s: float,
                   controller: Optional[HybridScaler] = None,
                   prefill_mode: str = "cotenant",
                   chunk_tokens: int = 256,
                   decode_token_equiv: float = 16.0,
                   max_queue: Optional[int] = None,
                   max_steps: int = 2_000_000) -> dict:
    """Serve `trace` with slot-based continuous batching.

    `prefill_mode`:
      * "cotenant"  — an admitted request's prompt runs as a co-resident
        prefill tenant: decode keeps stepping, priced with
        `prefill_tenants` extra spatial tenants; the slot goes live when
        its prefill completes.
      * "timeslice" — prefill runs serially on the tenant's own clock;
        decode stalls for `prefill_ms` per admission.
      * "chunked"   — prefill is split into fixed token-budget chunks
        piggybacked into decode steps: each step advances up to
        `chunk_tokens` prefill tokens (FIFO across pending prompts),
        priced as `len(live) + chunk_tokens / decode_token_equiv` on the
        existing token-latency grid (`decode_token_equiv` prefill tokens
        cost one decode-token equivalent — prefill is compute-dense where
        decode is weight-streaming bound).  A prompt's slot goes live the
        step its last chunk lands; decode never stalls.
    """
    if prefill_mode not in ("cotenant", "timeslice", "chunked"):
        raise ValueError(prefill_mode)
    trace = [dataclasses.replace(r) for r in trace]   # engines never share
    prof = executor.profile
    prefill_s = prof.prefill_ms / 1e3
    mem_cap = memory_slot_cap(executor, max_slots, mtl)

    clock = 0.0
    queue: deque = deque()
    live: list = []       # [request, tokens_remaining]
    pending: list = []    # [request, prefill_done_t]   (cotenant mode)
    idx = 0               # next trace arrival
    completed = rejected = steps = 0
    tokens_out = 0
    energy_j = 0.0
    finished: list = []
    window = TailLatencyWindow(window=200)
    cur_share = None
    truncated = False

    def slot_cap() -> int:
        cap = max_slots
        if controller is not None:
            cap = min(cap, max(1, int(controller.action().bs)))
        return min(cap, mem_cap)

    while True:
        # 1. pull arrivals up to the clock into the bounded queue
        while idx < len(trace) and trace[idx].arrival_s <= clock:
            if max_queue is not None and len(queue) >= max_queue:
                rejected += 1
            else:
                queue.append(trace[idx])
            idx += 1
        # 2. spatial-share trading: align the executor's slice with the
        #    controller's current request (repricing only, no relaunch)
        if controller is not None and controller.share is not None:
            s = controller.share
            if s != cur_share:
                executor.set_partition(TenantSlice(share=s))
                controller.set_granted_share(s)
                cur_share = s
        # 3. admit-on-free-slot into the RUNNING batch
        cap = slot_cap()
        chunked = prefill_mode == "chunked"
        while queue and len(live) + len(pending) < cap:
            req = queue.popleft()
            req.admit_s = clock
            if prefill_mode == "timeslice":
                clock += prefill_s          # decode stalls on this tenant
                req.first_token_s = clock
                live.append([req, req.decode_tokens])
            elif chunked:                   # prompt joins the chunk queue
                pending.append([req, max(int(req.prefill_tokens), 1)])
            else:
                pending.append([req, clock + prefill_s])
        # 4. activate co-resident prefills that completed
        if pending and not chunked:
            still = []
            for req, done_t in pending:
                if done_t <= clock:
                    req.first_token_s = done_t
                    live.append([req, req.decode_tokens])
                else:
                    still.append([req, done_t])
            pending = still
        # 5. one decode step: every live slot emits one token (chunked
        #    mode also advances up to `chunk_tokens` prefill tokens)
        if live or (chunked and pending):
            extra = 0.0
            if chunked and pending:
                budget = chunk_tokens       # FIFO within the chunk budget
                for rec in pending:
                    if budget <= 0:
                        break
                    take = min(budget, rec[1])
                    rec[1] -= take
                    budget -= take
                extra = (chunk_tokens - budget) / decode_token_equiv
            if live:
                r = executor.run_token_step(
                    len(live), mtl,
                    prefill_tenants=0 if chunked else len(pending),
                    extra_slots=extra)
                lat = r["step_time"]
                power = r["power_w"]
            else:
                # chunked prefill-only step: no slot decodes; the chunk is
                # priced alone on the same grid (a batch of `extra`
                # decode-token equivalents, power at the bs=1 draw)
                mean = executor.token_step_latency(0, mtl, 0, extra)
                lat = float(executor.sampler.sample(mean, n=1)[0])
                executor.clock += lat
                power = executor.power_terms(1, mtl)[0]
            clock += lat
            steps += 1
            tokens_out += len(live) * mtl
            energy_j += power * lat
            if live:
                window.add_many(np.full(min(len(live), 64), lat))
                if controller is not None:
                    controller.observe(window.p95,
                                       {"items": len(live),
                                        "step_time": lat})
            still = []
            for rec in live:
                rec[1] -= 1
                rec[0].decode_time_s += lat
                if rec[1] == 0:             # evict-on-EOS: slot frees NOW
                    rec[0].finish_s = clock
                    completed += 1
                    finished.append(rec[0])
                else:
                    still.append(rec)
            live = still
            if chunked and pending:
                still_p = []
                for rec in pending:
                    if rec[1] <= 0:         # last chunk landed: KV is live
                        rec[0].first_token_s = clock
                        live.append([rec[0], rec[0].decode_tokens])
                    else:
                        still_p.append(rec)
                pending = still_p
        elif pending:                       # idle until a prefill lands
            clock = min(done_t for _, done_t in pending)
            continue
        elif idx < len(trace):              # idle until the next arrival
            clock = trace[idx].arrival_s
            continue
        else:
            break
        if steps >= max_steps:
            truncated = True
            break

    backlog = len(queue) + len(live) + len(pending)
    return _token_report(
        "continuous", finished, clock=clock, tokens_out=tokens_out,
        steps=steps, energy_j=energy_j, submitted=idx, completed=completed,
        rejected=rejected, backlog=backlog, ttft_slo_s=ttft_slo_s,
        tpot_slo_s=tpot_slo_s, truncated=truncated)


# ---------------------------------------------------------------------------
# Static bucketed baseline
# ---------------------------------------------------------------------------
def run_static(trace: Sequence[TokenRequest], executor, *,
               bs: int = 32, mtl: int = 1,
               ttft_slo_s: float, tpot_slo_s: float,
               max_steps: int = 2_000_000) -> dict:
    """The same trace under classic fixed-shape batching: wait for `bs`
    requests (or end of trace), batched prefill, then decode at FULL `bs`
    until the longest member drains — finished sequences HOLD their slots,
    which is precisely the waste continuous batching removes."""
    trace = [dataclasses.replace(r) for r in trace]
    prof = executor.profile
    prefill_s = prof.prefill_ms / 1e3
    bs = min(bs, memory_slot_cap(executor, bs, mtl))

    clock = 0.0
    steps = 0
    tokens_out = 0
    energy_j = 0.0
    finished: list = []
    truncated = False
    i = 0
    while i < len(trace):
        batch = trace[i:i + bs]
        i += len(batch)
        # the fixed-shape engine waits for its batch to fill
        start = max(clock, batch[-1].arrival_s)
        p_end = start + prefill_s * len(batch)   # batched, compute-bound
        d_max = max(r.decode_tokens for r in batch)
        n_steps = min(d_max, max_steps - steps)
        mean = executor.token_step_latency(len(batch), mtl)
        lats = executor.sampler.sample(mean, n=n_steps)
        cum = np.cumsum(lats)
        power = dm.power(executor.device, prof, len(batch), mtl)
        for req in batch:
            req.admit_s = start
            req.first_token_s = p_end
            d = min(req.decode_tokens, n_steps)
            if d == req.decode_tokens:
                req.finish_s = p_end + float(cum[d - 1])
                finished.append(req)
            req.decode_time_s = float(cum[d - 1]) if d else 0.0
            tokens_out += d * mtl
        steps += n_steps
        clock = p_end + float(cum[-1]) if n_steps else p_end
        executor.clock += float(cum[-1]) if n_steps else 0.0
        energy_j += power * float(cum[-1]) if n_steps else 0.0
        if steps >= max_steps:
            truncated = True
            break

    completed = len(finished)
    backlog = len(trace) - completed
    return _token_report(
        "static", finished, clock=clock, tokens_out=tokens_out, steps=steps,
        energy_j=energy_j, submitted=len(trace), completed=completed,
        rejected=0, backlog=backlog, ttft_slo_s=ttft_slo_s,
        tpot_slo_s=tpot_slo_s, truncated=truncated)


# ---------------------------------------------------------------------------
# Reports and entry points
# ---------------------------------------------------------------------------
def _token_report(policy: str, finished, *, clock, tokens_out, steps,
                  energy_j, submitted, completed, rejected, backlog,
                  ttft_slo_s, tpot_slo_s, truncated) -> dict:
    ttft = np.asarray([r.ttft_s for r in finished], np.float64)
    tpot = np.asarray([r.tpot_s for r in finished], np.float64)
    dtoks = np.asarray([r.decode_tokens for r in finished], np.float64)
    ok = ((ttft <= ttft_slo_s) & (tpot <= tpot_slo_s)) if len(finished) \
        else np.zeros(0, bool)
    makespan = max(clock, 1e-12)
    n = max(len(finished), 1)
    return {
        "policy": policy,
        "requests": list(finished),     # the engine's own copies, stamped
        "submitted": int(submitted),
        "completed": int(completed),
        "rejected": int(rejected),
        "backlog": int(backlog),
        "conserved": submitted == completed + rejected + backlog,
        "makespan_s": float(makespan),
        "steps": int(steps),
        "tokens_out": int(tokens_out),
        "throughput_tokens_s": tokens_out / makespan,
        # goodput: decode tokens of requests that met BOTH per-token SLOs
        "goodput_tokens_s": float(dtoks[ok].sum()) / makespan,
        "ttft_p95_s": float(np.quantile(ttft, 0.95)) if len(ttft) else 0.0,
        "tpot_p95_s": float(np.quantile(tpot, 0.95)) if len(tpot) else 0.0,
        "ttft_attainment": float((ttft <= ttft_slo_s).sum()) / n,
        "tpot_attainment": float((tpot <= tpot_slo_s).sum()) / n,
        "slo_attainment": float(ok.sum()) / n,
        "mean_live_slots": tokens_out / max(steps, 1),
        "energy_j": float(energy_j),
        "ttft_slo_s": float(ttft_slo_s),
        "tpot_slo_s": float(tpot_slo_s),
        "truncated": bool(truncated),
    }


def run_token_serving(profile: dm.JobProfile, *, policy: str = "continuous",
                      device: dm.Device = dm.TPU_V5E, seed: int = 0,
                      trace: Optional[Sequence[TokenRequest]] = None,
                      n_requests: int = 400, rate_rps: float = 30.0,
                      max_slots: int = 32, static_bs: Optional[int] = None,
                      mtl: int = 1, ttft_slo_s: float = 2.0,
                      tpot_slo_s: float = 0.25,
                      use_controller: bool = False,
                      share_ladder=None,
                      prefill_mode: str = "cotenant",
                      chunk_tokens: int = 256,
                      decode_token_equiv: float = 16.0,
                      max_queue: Optional[int] = None,
                      executor=None) -> dict:
    """One decode job served token by token — the `serve.py --token-engine`
    entry point.  `policy="continuous"` runs the slot engine (optionally
    under a HybridScaler driving live slots / shares), `policy="static"`
    the fixed-shape bucketed baseline on the SAME trace."""
    if trace is None:
        trace = ragged_decode_trace(n_requests, seed, rate_rps=rate_rps)
    if executor is None:
        executor = SimExecutor(profile, device, seed=seed)
    if policy == "static":
        return run_static(trace, executor, bs=static_bs or max_slots,
                          mtl=mtl, ttft_slo_s=ttft_slo_s,
                          tpot_slo_s=tpot_slo_s)
    if policy != "continuous":
        raise ValueError(policy)
    controller = None
    if use_controller:
        controller = build_token_controller(executor, tpot_slo_s,
                                            max_slots=max_slots, mtl=mtl,
                                            share_ladder=share_ladder)
    return run_continuous(trace, executor, max_slots=max_slots, mtl=mtl,
                          ttft_slo_s=ttft_slo_s, tpot_slo_s=tpot_slo_s,
                          controller=controller, prefill_mode=prefill_mode,
                          chunk_tokens=chunk_tokens,
                          decode_token_equiv=decode_token_equiv,
                          max_queue=max_queue)


def run_token_cluster(profiles: Sequence[dm.JobProfile], *,
                      device: dm.Device = dm.TPU_V5E, seed: int = 0,
                      **kwargs) -> dict:
    """Fleet-level per-token accounting: one token engine per decode job
    (job i on its own device with its own seeded noise stream), aggregated
    with the cluster engines' conservation convention — the fleet is
    conserved iff every job is and the totals add up."""
    jobs = [run_token_serving(p, device=device, seed=seed + 17 * i, **kwargs)
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
