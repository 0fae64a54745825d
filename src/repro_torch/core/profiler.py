"""Profiler module (paper §3.2.1): decide Batching vs Multi-Tenancy.

Measures throughput at BS in {1, m} (MTL=1) and MTL in {1, n} (BS=1); m=32,
n=8 as in the paper.  TI_B (eq. 3) and TI_MT (eq. 4) are compared (eq. 5);
ties go to the lower-latency approach.  A few batches per point keep the
probe "of the order of seconds".
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ProfileResult:
    ti_b: float                 # % throughput improvement from batching
    ti_mt: float                # % from multi-tenancy
    approach: str               # 'B' | 'MT'
    thr_base: float             # items/s at BS=1, MTL=1
    thr_bs_m: float
    thr_mtl_n: float
    lat_base: float
    lat_bs_m: float
    lat_mtl_n: float
    probe_time_s: float

    def observed(self) -> dict:
        """Latency observations reusable by matrix completion (paper: the
        MTL=1 and MTL=n points come for free from profiling)."""
        return {1: self.lat_base, None: None}


class Profiler:
    def __init__(self, executor, *, m: int = 32, n: int = 8,
                 probe_steps: int = 3):
        self.executor = executor
        self.m = m
        self.n = n
        self.probe_steps = probe_steps

    def _measure(self, bs: int, mtl: int) -> tuple[float, float, float]:
        """Returns (throughput items/s, median step latency, time spent).

        Median over the probe batches — a single OS/thermal spike in a
        3-sample probe would otherwise flip the B-vs-MT decision."""
        times, items, tot_time = [], 0, 0.0
        for _ in range(self.probe_steps):
            r = self.executor.run_step(bs, mtl)
            items += r["items"]
            times.append(r["step_time"])
            tot_time += r["step_time"]
        times.sort()
        med = times[len(times) // 2]
        per_step_items = items / self.probe_steps
        return per_step_items / med, med, tot_time

    def probe(self) -> ProfileResult:
        thr1, lat1, t1 = self._measure(1, 1)
        thr_b, lat_b, t2 = self._measure(self.m, 1)
        thr_mt, lat_mt, t3 = self._measure(1, self.n)

        ti_b = (thr_b - thr1) / thr1 * 100.0          # eq. (3)
        ti_mt = (thr_mt - thr1) / thr1 * 100.0        # eq. (4)
        if ti_b > ti_mt:                              # eq. (5)
            approach = "B"
        elif ti_b < ti_mt:
            approach = "MT"
        else:
            approach = "B" if lat_b <= lat_mt else "MT"

        res = ProfileResult(
            ti_b=ti_b, ti_mt=ti_mt, approach=approach,
            thr_base=thr1, thr_bs_m=thr_b, thr_mtl_n=thr_mt,
            lat_base=lat1, lat_bs_m=lat_b, lat_mtl_n=lat_mt,
            probe_time_s=t1 + t2 + t3)
        return res

    def mt_observations(self, res: ProfileResult) -> dict:
        """{MTL: per-step latency} observed during profiling — the two free
        points for matrix completion."""
        return {1: res.lat_base, self.n: res.lat_mtl_n}
