"""Serving engine: closed-loop request processing under a controller.

The engine owns the executor, the tail-latency window, instance lifecycle
costs (launching/terminating co-located instances stalls the service — the
very overhead that motivates the paper's matrix-completion jump), and the
metrics accumulator.  Controllers (repro_torch.core) expose:

    action()              -> Action(bs, mtl)
    observe(p95, result)  -> None        (called after every step)

Dynamic batch-size changes are free (the paper's dynamic batch sizing);
MTL changes cost `instance_launch_s` per added and `instance_kill_s` per
removed instance.  Executors that compile on demand (RealExecutor's AOT
cache) report the compile wall time in ``result["compile_time"]``; it is
charged to the engine clock exactly like an instance-launch stall, so
adaptation cost is modeled rather than hidden.

The per-step open-loop mechanics (stall accounting, the stall-spanning
arrival window, bounded-queue overflow) are shared with
``serving.cluster.ClusterEngine`` via ``reconfig_stall`` and
``OpenLoopQueue`` — one implementation, patched once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.serving.metrics import RunAccumulator, TailLatencyWindow


@dataclasses.dataclass
class Action:
    bs: int = 1
    mtl: int = 1
    share: Optional[float] = None   # requested partition share (3rd knob);
    #                                 None = no spatial partitioning — the
    #                                 engines ignore it, ClusterEngine's
    #                                 partition mode mediates the grant


def reconfig_stall(prev: Action, act: Action, launch_s: float,
                   kill_s: float) -> float:
    """Stall seconds for moving prev -> act.  BS changes are free (dynamic
    batch sizing); MTL changes cost per instance launched/killed."""
    if act.mtl == prev.mtl:
        return 0.0
    delta = act.mtl - prev.mtl
    return launch_s * max(delta, 0) + kill_s * max(-delta, 0)


class OpenLoopQueue:
    """Open-loop request bookkeeping shared by OpenLoopEngine and
    ClusterEngine: a (possibly time-varying) Poisson arrival process, the
    stall-spanning arrival window, bounded-queue overflow (oldest dropped
    first), and exact request conservation —
    ``submitted == completed + rejected + backlog`` at every step."""

    def __init__(self, rate_fn: Callable[[float], float], *,
                 max_queue: int, seed: int = 0,
                 piecewise_s: Optional[float] = None,
                 step_breaks: Optional[Callable] = None):
        self.rate_fn = rate_fn
        self.rng = np.random.default_rng(seed)
        self.queue: list = []            # arrival timestamps
        self.submitted = 0
        self.rejected = 0
        self.max_queue = max_queue
        # sub-interval bound for the piecewise rate integral: a
        # time-varying rate_fn is integrated over knots at most this far
        # apart (trapezoid), so a stall-stretched window spanning a burst
        # phase boundary is priced by the rate it actually saw — not by
        # one sample at win_start.  None keeps the single-point product,
        # which is exact for constant rates (the cluster queues).
        self.piecewise_s = piecewise_s
        # registered step rate: rate_fn is piecewise-CONSTANT and
        # step_breaks(a, b) returns its jump points inside (a, b), sorted
        # ascending.  The integral is then an exact left-Riemann sum with
        # knots snapped at the discontinuities — the trapezoid above
        # averages the high/low rates on any sub-interval straddling a
        # jump, mispricing every burst edge (systematic under flash-crowd
        # traces).  Takes precedence over piecewise_s.
        self.step_breaks = step_breaks

    @property
    def backlog(self) -> int:
        return len(self.queue)

    def expected_arrivals(self, win_start: float, a_end: float) -> float:
        """Integral of rate_fn over [win_start, a_end]: the Poisson mean
        for the window.  With `piecewise_s` set, a trapezoid over
        sub-intervals no longer than it; a window over which every knot
        rate is equal — constant-rate traffic — keeps the exact
        rate * window product, bit-identical to the legacy single-point
        path."""
        window = max(a_end - win_start, 0.0)
        if window <= 0.0 or (self.piecewise_s is None
                             and self.step_breaks is None):
            return self.rate_fn(win_start) * window
        if self.step_breaks is not None:
            # exact integral of a registered piecewise-constant rate: each
            # segment between jump points is priced at its left endpoint
            knots = [win_start]
            for b in self.step_breaks(win_start, a_end):
                b = float(b)
                if win_start < b < a_end:
                    knots.append(b)
            knots.append(a_end)
            return float(sum(float(self.rate_fn(lo)) * (hi - lo)
                             for lo, hi in zip(knots, knots[1:])))
        seg = max(float(self.piecewise_s), 1e-12)
        n = max(int(np.ceil(window / seg)), 1)
        knots = np.linspace(win_start, a_end, n + 1)
        rates = np.asarray([float(self.rate_fn(float(t))) for t in knots],
                           np.float64)
        if np.all(rates == rates[0]):
            return float(rates[0]) * window
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(rates, knots))

    def step(self, win_start: float, t_end: float, capacity: int,
             arrival_end: Optional[float] = None) -> tuple:
        """Arrivals over [win_start, t_end] — the window spans any
        launch/kill or compile stall, because the outside world does not
        pause while instances restart — then overflow, then serve up to
        `capacity` oldest requests.  Returns (served timestamps,
        end-to-end latencies).

        `arrival_end` clips the arrival window (a draining job stops
        receiving requests at its departure time even while it is still
        serving down its backlog); service still completes at `t_end`."""
        a_end = t_end if arrival_end is None else min(t_end, arrival_end)
        window = max(a_end - win_start, 0.0)
        n_arr = int(self.rng.poisson(
            self.expected_arrivals(win_start, a_end)))
        self.submitted += n_arr
        if n_arr:
            self.queue.extend(np.sort(
                win_start + self.rng.random(n_arr) * window))
        if len(self.queue) > self.max_queue:
            drop = len(self.queue) - self.max_queue
            self.rejected += drop
            self.queue = self.queue[drop:]
        served, self.queue = self.queue[:capacity], self.queue[capacity:]
        return served, [t_end - ts for ts in served]


class ServingEngine:
    def __init__(self, executor, slo_s: float, *,
                 window: int = 200,
                 instance_launch_s: float = 2.0,
                 instance_kill_s: float = 0.3,
                 slo_schedule: Optional[Callable[[float], float]] = None):
        self.executor = executor
        self.base_slo = slo_s
        self.window = TailLatencyWindow(window=window)
        self.acc = RunAccumulator()
        self.instance_launch_s = instance_launch_s
        self.instance_kill_s = instance_kill_s
        self.slo_schedule = slo_schedule
        self.reconfig_time = 0.0

    def current_slo(self) -> float:
        if self.slo_schedule is not None:
            return self.slo_schedule(self.acc.total_time)
        return self.base_slo

    def _charge_reconfig(self, prev: Action, act: Action) -> None:
        """Shared stall accounting: MTL moves stall the service; any knob
        change invalidates the tail window (the paper 'processes a certain
        number of batches and measures their tail latency' per point)."""
        cost = reconfig_stall(prev, act, self.instance_launch_s,
                              self.instance_kill_s)
        if cost:
            self.acc.total_time += cost
            self.reconfig_time += cost
        if (act.bs, act.mtl) != (prev.bs, prev.mtl):
            self.window.reset()

    def _charge_compile(self, res: dict) -> float:
        """AOT compile time reported by the executor is an engine stall."""
        comp = res.get("compile_time", 0.0)
        if comp:
            self.acc.total_time += comp
            self.acc.compile_stall_s += comp
        return comp

    def run(self, controller, *, max_steps: int = 2000,
            sim_time_limit: Optional[float] = None) -> RunAccumulator:
        prev = Action(bs=1, mtl=1)
        for _ in range(max_steps):
            slo = self.current_slo()
            if hasattr(controller, "set_slo"):
                controller.set_slo(slo)
            act = controller.action()
            self._charge_reconfig(prev, act)
            res = self.executor.run_step(act.bs, act.mtl)
            self._charge_compile(res)
            self.window.add_many(res["request_latencies"])
            self.acc.record_step(
                items=res["items"], step_time=res["step_time"],
                power_w=res["power_w"],
                request_latencies=res["request_latencies"], slo=slo)
            self.acc.trace.append(
                (self.acc.total_time, act.bs, act.mtl, self.window.p95,
                 res["throughput"], slo))
            controller.observe(self.window.p95, res)
            prev = act
            if sim_time_limit and self.acc.total_time >= sim_time_limit:
                break
        return self.acc


class OpenLoopEngine(ServingEngine):
    """Open-loop serving: requests arrive via a (bursty) Poisson process and
    queue; per-request latency = queueing wait + batch service time.  This is
    the regime of the paper's §3.2 note that "some inference workloads arrive
    in a burst and not uniformly" — controllers must absorb bursts without
    violating the SLO for long.
    """

    def __init__(self, executor, slo_s: float, *, arrival_rate: float,
                 burst_factor: float = 1.0, burst_period_s: float = 30.0,
                 seed: int = 0, max_queue: int = 100_000, **kw):
        super().__init__(executor, slo_s, **kw)
        self.arrival_rate = arrival_rate
        self.burst_factor = burst_factor
        self.burst_period_s = burst_period_s
        # the burst rate is piecewise-constant with known jump points, so
        # it registers them for the exact left-Riemann integral; constant
        # rates keep the exact single-point product
        self.oq = OpenLoopQueue(
            self._rate, max_queue=max_queue, seed=seed,
            step_breaks=(self._burst_breaks if burst_factor > 1.0
                         else None))

    # backwards-compatible views over the shared queue helper
    @property
    def queue(self) -> list:
        return self.oq.queue

    @property
    def dropped(self) -> int:
        return self.oq.rejected

    @property
    def max_queue(self) -> int:
        return self.oq.max_queue

    def _rate(self, t: float) -> float:
        if self.burst_factor <= 1.0:
            return self.arrival_rate
        phase = (t % self.burst_period_s) / self.burst_period_s
        return self.arrival_rate * (self.burst_factor if phase < 0.3 else 1.0)

    def _burst_breaks(self, a: float, b: float) -> list:
        """Jump points of _rate inside (a, b): m*period (burst on) and
        (m + 0.3)*period (burst off) for every period m the window spans."""
        period = self.burst_period_s
        out = []
        t = np.floor(a / period) * period
        while t <= b:
            for x in (t, t + 0.3 * period):
                if a < x < b:
                    out.append(x)
            t += period
        return out

    def run(self, controller, *, max_steps: int = 2000,
            sim_time_limit=None) -> RunAccumulator:
        prev = Action(bs=1, mtl=1)
        for _ in range(max_steps):
            slo = self.current_slo()
            if hasattr(controller, "set_slo"):
                controller.set_slo(slo)
            act = controller.action()
            win_start = self.acc.total_time   # arrivals span any stall too
            self._charge_reconfig(prev, act)
            res = self.executor.run_step(act.bs, act.mtl)
            self._charge_compile(res)
            t1 = self.acc.total_time + res["step_time"]
            served_ts, lats = self.oq.step(win_start, t1,
                                           act.bs * act.mtl)
            self.acc.record_step(
                items=len(served_ts), step_time=res["step_time"],
                power_w=res["power_w"], request_latencies=lats, slo=slo)
            # The controller observes SERVICE latency (as in the paper's
            # closed-loop measurement): feeding it queue-inclusive latency
            # would make the batch scaler shrink the batch exactly when the
            # backlog demands growing it (a death spiral).  End-to-end
            # (queue + service) latencies still go to the accumulator above.
            self.window.add_many(res["request_latencies"])
            self.acc.trace.append(
                (t1, act.bs, act.mtl, self.window.p95,
                 len(served_ts) / res["step_time"], slo))
            controller.observe(self.window.p95, res)
            prev = act
            if sim_time_limit and self.acc.total_time >= sim_time_limit:
                break
        return self.acc
