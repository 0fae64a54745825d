"""What the metrics read: the window's steps on the host clock, and the
device trace of the steps served right after it.  A per-layer metric is a
file ``bench/metrics/<name>.py`` whose ``read(ctx)`` returns a number, or
None where it finds nothing to read."""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

from bench import counts


@dataclasses.dataclass
class Trace:
    events: list          # (name, start us, end us) of each device activity
    lo: float             # first traced step's start (us)
    hi: float             # last traced step's end (us)
    steps: list           # the traced steps (serve.Step)
    host: list            # (label, start us, end us) of the harness's ranges

    @property
    def busy_us(self) -> float:
        return counts.union_s([(s, e) for _, s, e in self.events],
                              self.lo, self.hi)

    @property
    def span_us(self) -> float:
        return self.hi - self.lo

    def kernels(self, pattern: str) -> list:
        """The device activities whose names match ``pattern``."""
        rx = re.compile(pattern)
        return [(n, s, e) for n, s, e in self.events if rx.search(n)]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations with the most time, and the longest idle
        gaps by what the host was doing at their middle."""
        by_name: dict = {}
        for n, s, e in self.events:
            key = n if len(n) <= 120 else n[:117] + "..."
            by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        for s, e in counts.gaps([(s, e) for _, s, e in self.events],
                                self.lo, self.hi):
            mid = (s + e) / 2
            inner = [(hi - lo, lab) for lab, lo, hi in self.host
                     if lo <= mid <= hi]
            label = min(inner)[1] if inner else "engine loop"
            gaps.append((label, (e - s) / 1e6))
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n, t] for n, t in ops],
                "idle_gaps": [[n, t] for n, t in gaps[:top]]}


@dataclasses.dataclass
class Context:
    conf: dict            # the configuration file
    traffic: dict         # the traffic file
    knobs: dict           # the cell's file
    slo_s: float
    steps: list           # the window's steps (serve.Step)
    window_s: float
    controller_s: float   # host seconds in the controller's calls
    trace: Optional[Trace] = None

    @property
    def latencies(self) -> np.ndarray:
        return np.array([s.t1 - s.t0 for s in self.steps])

    @property
    def items(self) -> np.ndarray:
        return np.array([s.items for s in self.steps])

    @property
    def requests(self) -> int:
        return int(self.items.sum())

    @property
    def good(self) -> int:
        """Requests whose step returned within the SLO."""
        return int(self.items[self.latencies <= self.slo_s].sum())

    def request_quantile(self, q: float) -> float:
        """The q-quantile of every request's latency: each request counts
        once, at the wall time of the step that served it."""
        lat, w = self.latencies, self.items
        order = np.argsort(lat, kind="stable")
        cum = np.cumsum(w[order])
        i = int(np.searchsorted(cum, q * cum[-1], side="left"))
        return float(lat[order][min(i, len(order) - 1)])
