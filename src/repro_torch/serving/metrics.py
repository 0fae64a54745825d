"""Serving metrics: sliding-window tail latency, throughput, power/energy,
and the real-executor AOT compile-cache counters."""

from __future__ import annotations

import dataclasses

import numpy as np


class TailLatencyWindow:
    """p95 (the paper's SLO metric) over the most recent N request latencies.

    Ring buffer + memoized quantile: the cluster engines read ``p95`` twice
    per step (trace + controller observation), which made ``np.quantile``
    over a deque the single hottest line of the 30-job cluster bench.  The
    quantile is recomputed only after the buffer changes, via a partial
    sort, reproducing ``np.quantile``'s linear interpolation exactly."""

    def __init__(self, window: int = 200, quantile: float = 0.95):
        self.window = window
        self.quantile = quantile
        self._buf = np.empty(window, np.float64)
        self._n = 0            # valid samples (<= window)
        self._i = 0            # next write slot
        self._p95: float | None = None

    def __len__(self) -> int:
        return self._n

    def add(self, latency_s: float, count: int = 1) -> None:
        self.add_many([latency_s] * count)

    def add_many(self, latencies) -> None:
        lat = np.asarray(latencies, np.float64).ravel()
        if lat.size >= self.window:          # only the newest `window` survive
            self._buf[:] = lat[-self.window:]
            self._n, self._i = self.window, 0
        elif lat.size:
            end = min(self._i + lat.size, self.window)
            head = end - self._i
            self._buf[self._i:end] = lat[:head]
            if head < lat.size:              # wrap around
                self._buf[:lat.size - head] = lat[head:]
            self._i = (self._i + lat.size) % self.window
            self._n = min(self._n + lat.size, self.window)
        self._p95 = None

    @property
    def p95(self) -> float:
        if self._n == 0:
            return 0.0
        if self._p95 is None:
            a = self._buf[:self._n]
            pos = self.quantile * (self._n - 1)
            lo = int(pos)
            if lo + 1 >= self._n:
                self._p95 = float(a.max())
            else:
                part = np.partition(a, (lo, lo + 1))
                self._p95 = float(part[lo] + (pos - lo) * (part[lo + 1]
                                                           - part[lo]))
        return self._p95

    @property
    def mean(self) -> float:
        return float(self._buf[:self._n].mean()) if self._n else 0.0

    def reset(self) -> None:
        self._n, self._i, self._p95 = 0, 0, None


@dataclasses.dataclass
class ExecCacheStats:
    """Hit/miss counters for RealExecutor's AOT executable cache.

    ``reset_counters`` is the warmup boundary: steady-state serving must
    show ``misses == 0`` afterwards (every scaler probe reuses a compiled
    executable).

    Executables are keyed by (batch bucket, tuned-tile generation): when
    the autotune generation bumps, resident executables are STALE —
    ``stale_evictions`` counts the ones dropped and recompiled, and
    ``stale_hits`` counts any served anyway.  ``stale_hits`` must stay 0:
    serving an executable compiled under superseded tile sizes silently
    undoes the tuning."""

    hits: int = 0
    misses: int = 0
    compile_time_s: float = 0.0
    stale_hits: int = 0
    stale_evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 1.0

    def reset_counters(self) -> None:
        self.hits = self.misses = 0
        self.compile_time_s = 0.0
        self.stale_hits = self.stale_evictions = 0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": self.hit_rate,
                "compile_time_s": self.compile_time_s,
                "stale_hits": self.stale_hits,
                "stale_evictions": self.stale_evictions}


class RunAccumulator:
    """Aggregates a serving run: throughput, SLO attainment, energy."""

    def __init__(self):
        self.total_items = 0
        self.total_time = 0.0
        self.energy_j = 0.0
        self.latencies: list = []
        self._bulk_lats: list = []     # request-latency ARRAYS appended by
        #                                record_bulk — kept whole instead of
        #                                exploded into the Python list
        self.trace: list = []          # (t, bs_or_mtl, p95, throughput)
        self.violations = 0
        self.requests = 0
        self.compile_stall_s = 0.0     # XLA compile time charged to the run

    def record_step(self, *, items: int, step_time: float, power_w: float,
                    request_latencies, slo: float) -> None:
        self.total_items += items
        self.total_time += step_time
        self.energy_j += power_w * step_time
        lat = list(request_latencies)
        self.latencies.extend(lat)
        self.requests += len(lat)
        self.violations += sum(1 for x in lat if x > slo)

    def record_bulk(self, *, items: int, busy_s: float, energy_j: float,
                    request_latencies, slo: float) -> None:
        """Aggregate a whole CHUNK of steps at once (the vectorized
        cluster path): totals accumulate exactly as repeated
        `record_step` calls would, but the request latencies stay one
        numpy array instead of thousands of list appends."""
        self.total_items += int(items)
        self.total_time += float(busy_s)
        self.energy_j += float(energy_j)
        lat = np.asarray(request_latencies, np.float64).reshape(-1)
        if lat.size:
            self._bulk_lats.append(lat)
        self.requests += int(lat.size)
        self.violations += int(np.count_nonzero(lat > slo))

    def _lat_array(self) -> np.ndarray:
        """All request latencies in arrival order, whichever recording
        path produced them."""
        if not self._bulk_lats:
            return np.asarray(self.latencies)
        parts = ([np.asarray(self.latencies, np.float64)]
                 if self.latencies else []) + self._bulk_lats
        return np.concatenate(parts)

    @property
    def throughput(self) -> float:
        return self.total_items / self.total_time if self.total_time else 0.0

    @property
    def avg_power(self) -> float:
        return self.energy_j / self.total_time if self.total_time else 0.0

    @property
    def power_efficiency(self) -> float:
        return self.throughput / self.avg_power if self.avg_power else 0.0

    @property
    def p95(self) -> float:
        lat = self._lat_array()
        if not lat.size:
            return 0.0
        return float(np.quantile(lat, 0.95))

    def tail_p95(self, frac: float = 0.5) -> float:
        """p95 over the last `frac` of requests — the steady-state tail once
        the scaler's search transient (which p95 over the whole run mixes
        in) has died out."""
        lat = self._lat_array()
        if not lat.size:
            return 0.0
        n = max(1, int(lat.size * frac))
        return float(np.quantile(lat[-n:], 0.95))

    @property
    def slo_attainment(self) -> float:
        if not self.requests:
            return 1.0
        return 1.0 - self.violations / self.requests

    def summary(self) -> dict:
        return {
            "throughput": self.throughput,
            "p95_s": self.p95,
            "avg_power_w": self.avg_power,
            "power_efficiency": self.power_efficiency,
            "slo_attainment": self.slo_attainment,
            "items": self.total_items,
            "sim_time_s": self.total_time,
            "compile_stall_s": self.compile_stall_s,
        }
