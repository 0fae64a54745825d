"""Structure-of-arrays per-job simulator state (the vectorized hot path).

`ClusterEngine` historically kept every per-job scalar — clock, arrival
mark, backlog, stall/migration accounting — as Python attributes on a
`_JobState` object and drove the lockstep loop through a heap of
`(clock, idx, epoch)` tuples.  That representation tops out far below the
1000-job x 1000-device regime the ROADMAP's scale item targets: the event
loop, the admission scan, and the stall-skew scan all walk Python objects.

`SimState` holds the same scalars as parallel numpy arrays, one slot per
job state.  `_JobState` exposes them through properties (reads return
plain Python scalars, so all arithmetic downstream is bit-identical to
the old attribute code), and the engines query the arrays directly for
the whole-fleet operations:

  * ``frontier()``      — the next event (argmin over active clocks); ties
    break toward the lowest index, exactly the order the reference heap's
    ``(clock, idx, epoch)`` tuples give, so an argmin-driven loop replays
    the heap-driven loop event for event.
  * ``next_event_clock()`` — the admission loop's "next step event" bound.
  * ``min_other_active_clock(i)`` — the running min-clock the stall-skew
    accounting reads; replaces the O(jobs) Python list rebuild that ran on
    every stall.

The tail windows are already vectorized ring buffers
(`metrics.TailLatencyWindow`); backlogs are mirrored into ``backlog`` by
the engine after every open-loop step so fleet-wide queue scans need no
object walk.

Sentinel conventions (arrays cannot hold None): ``depart_s`` uses +inf
for "never departs", ``drained_at`` uses NaN for "still active", and
``feasible_at_serve`` is an int8 tri-state (-1 = never served, else 0/1
— the feasibility snapshot `report()` prefers over recomputing from
whoever lives on the device at the horizon).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_FLOAT_FIELDS = (
    "clock", "arrival_mark", "admit_s", "depart_s", "drained_at",
    "stall_time", "migration_stall_s", "migration_modeled_s",
    "measured_migration_s", "resize_stall_s",
)
_INT_FIELDS = (
    "epoch", "migrations", "resizes", "submitted", "completed", "backlog",
    # spot revocation: 1 once the job was force-killed at a grace-window
    # deadline (its stranded backlog moved to rejected, not dropped)
    "preempted",
)
_BOOL_FIELDS = ("active",)


class SimState:
    """Parallel per-job state arrays; one slot per `_JobState`."""

    def __init__(self, capacity: int = 16):
        cap = max(int(capacity), 1)
        self._n = 0
        for f in _FLOAT_FIELDS:
            setattr(self, f, np.zeros(cap, np.float64))
        for f in _INT_FIELDS:
            setattr(self, f, np.zeros(cap, np.int64))
        for f in _BOOL_FIELDS:
            setattr(self, f, np.zeros(cap, np.bool_))
        self.feasible_at_serve = np.full(cap, -1, np.int8)

    def __len__(self) -> int:
        return self._n

    def _grow(self, need: int) -> None:
        cap = self.clock.shape[0]
        if need <= cap:
            return
        new = max(need, 2 * cap)
        for f in _FLOAT_FIELDS + _INT_FIELDS + _BOOL_FIELDS + \
                ("feasible_at_serve",):
            arr = getattr(self, f)
            ext = np.full(new, -1, np.int8) if f == "feasible_at_serve" \
                else np.zeros(new, arr.dtype)
            ext[:cap] = arr
            setattr(self, f, ext)

    def add_job(self, *, admit_s: float = 0.0,
                depart_s: Optional[float] = None) -> int:
        """Allocate one slot; returns its index."""
        i = self._n
        self._grow(i + 1)
        self._n = i + 1
        self.clock[i] = admit_s
        self.arrival_mark[i] = admit_s
        self.admit_s[i] = admit_s
        self.depart_s[i] = np.inf if depart_s is None else depart_s
        self.drained_at[i] = np.nan
        self.active[i] = True
        self.feasible_at_serve[i] = -1
        return i

    # -- whole-fleet queries the event loop runs every round ------------------
    def _masked_clocks(self) -> np.ndarray:
        n = self._n
        return np.where(self.active[:n], self.clock[:n], np.inf)

    def next_event_clock(self) -> float:
        """Smallest active clock (+inf when no job is active) — the bound
        the admission loop compares pending arrivals against."""
        if self._n == 0:
            return float("inf")
        return float(self._masked_clocks().min())

    def frontier(self) -> int:
        """Index of the next event: the active job with the smallest
        clock, ties toward the lowest index (argmin's first occurrence —
        the same tie-break as the reference heap's (clock, idx, epoch)
        tuples).  -1 when no job is active."""
        n = self._n
        if n == 0 or not self.active[:n].any():
            return -1
        return int(np.argmin(self._masked_clocks()))

    def min_other_active_clock(self, i: int) -> float:
        """min over every OTHER active job's clock (+inf when there is
        none) — the stall-skew scan, without rebuilding a Python list."""
        m = self._masked_clocks()
        if m.size == 0:
            return float("inf")
        m[i] = np.inf            # _masked_clocks returned a fresh array
        return float(m.min())
