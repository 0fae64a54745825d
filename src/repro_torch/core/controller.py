"""DNNScaler controller (paper §3.2): Profiler -> Scaler, plus baselines.

DNNScalerController drives the serving engine for one job:
  1. Profiler probes BS in {1,m} / MTL in {1,n}, picks Batching or
     Multi-Tenancy (eq. 3-5).
  2. The matching Scaler maintains p95 <= SLO while maximizing throughput
     (binary search on BS, or matrix-completion + AIMD on MTL).

`mode` selects the approach policy:
  "auto"   — the paper's Algorithm 1: profile, then commit to B or MT;
  "hybrid" — beyond the paper: a HybridScaler jointly tunes (BS, MTL) by
             coordinate descent, seeded by the matrix-completion estimate;
  "B"/"MT" — force one pure strategy (the Fig. 11 sole-knob ablations).

StaticController fixes (bs, mtl) — used for the Fig. 1 sweeps and the
Fig. 11/12 combination studies.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.clipper import ClipperController
from repro_torch.core.matrix_completion import LatencyEstimator
from repro_torch.core.profiler import Profiler, ProfileResult
from repro_torch.core.scaler import ALPHA, BatchScaler, HybridScaler, MTScaler
from repro_torch.serving.engine import Action


class DNNScalerController:
    name = "dnnscaler"

    def __init__(self, executor, slo_s: float, *,
                 estimator: Optional[LatencyEstimator] = None,
                 max_bs: int = 128, max_mtl: int = 10,
                 m: int = 32, n: int = 8, decision_interval: int = 5,
                 mode: str = "auto", surface_library=None,
                 surface_key=None, share_ladder=None):
        if mode not in ("auto", "hybrid", "B", "MT"):
            raise ValueError(f"unknown mode {mode!r}")
        self.slo = slo_s
        self.mode = mode
        # spatial-partition third knob (serving/partition.py): only the
        # HybridScaler searches it; the 1-D paper scalers ignore it
        self.share_ladder = share_ladder
        self.max_bs = max_bs
        self.max_mtl = max_mtl
        self.estimator = estimator or LatencyEstimator(max_mtl=max_mtl)
        # cross-job shared surface (core.matrix_completion.SurfaceLibrary):
        # every probed (bs, mtl) point this controller serves is pooled
        # into the jobs x knobs matrix, and a new job seeds its scaler
        # from the soft-impute completion of similar jobs' rows
        self.surface_library = surface_library
        self.surface_key = surface_key
        self.profiler = Profiler(executor, m=m, n=n)
        self.profile: ProfileResult = self.profiler.probe()
        # distinct (bs, mtl) operating points this controller has tried —
        # the probing cost the cross-run profile store amortizes away; a
        # warm-started controller must reach steady state with fewer
        self.probed_points = {(1, 1), (m, 1), (1, n)}
        if surface_library is not None:
            # the profiler's three points — (1,1), (m,1), (1,n) — are free
            # observations for the shared surface (paper: profiling points
            # come for free for matrix completion)
            p = self.profile
            for (bs, mtl), lat in (((1, 1), p.lat_base), ((m, 1), p.lat_bs_m),
                                   ((1, n), p.lat_mtl_n)):
                surface_library.observe(surface_key, bs, mtl, lat)

        picked = self.profile.approach if mode == "auto" else mode
        if picked == "hybrid":
            # the profiler's winner is the primary knob; the secondary knob
            # is grown opportunistically once the primary saturates
            observed = self.profiler.mt_observations(self.profile)
            self.scaler = HybridScaler(slo_s, self.estimator, observed,
                                       primary=self.profile.approach,
                                       max_bs=max_bs, max_mtl=max_mtl,
                                       decision_interval=decision_interval,
                                       share_ladder=share_ladder)
            self._seed_scaler_surface(executor)
        elif picked == "B":
            self.scaler = BatchScaler(slo_s, max_bs=max_bs,
                                      decision_interval=decision_interval)
        else:
            observed = self.profiler.mt_observations(self.profile)
            self.scaler = MTScaler(slo_s, self.estimator, observed,
                                   max_mtl=max_mtl,
                                   decision_interval=decision_interval)

    def _seed_scaler_surface(self, executor) -> None:
        """Pin the HybridScaler's infeasible frontier before the first
        probe.  Preference order: the cross-job SurfaceLibrary completion
        (history of architecturally similar jobs, de-normalized by this
        job's own base point) when it has enough data; otherwise the
        executor's analytic `price_surface` floor."""
        self._surface = None
        self._surface_margin = 1.0
        model_start = None
        lib = self.surface_library
        if lib is not None:
            # a partitioned scaler seeds from the tensor slice at ITS rung
            share = getattr(self.scaler, "share", None)
            pred = (lib.predict(self.surface_key, share=share)
                    if share is not None else lib.predict(self.surface_key))
            if pred is not None and getattr(lib, "last_tier",
                                            "library") == "model":
                # zero-probe cost-model prior: its support mask is
                # all-False by construction, so it must NEVER pin the
                # frontier or jump like probed history — it only nominates
                # a START point for the climb, at a conservative 0.6*SLO
                # target (prediction error budget on top of the library
                # path's 0.75 mean-to-p95 slack).  Pins still come from
                # the analytic price_surface floor below, exactly as if
                # the library had refused outright.
                from repro_torch.serving.device_model import best_feasible_point
                est = pred[0]
                if est.ndim == 3:
                    est = est[:, :, 0]       # largest rung (full share)
                bs_vals = np.asarray(lib.bs_values)
                mtl_vals = np.asarray(lib.mtl_values)
                keep = bs_vals <= self.max_bs
                mtl_keep = mtl_vals[mtl_vals <= self.max_mtl]
                best = best_feasible_point(est[keep][:, :len(mtl_keep)],
                                           bs_vals[keep], mtl_keep,
                                           0.6 * self.slo)
                if best is not None:
                    model_start = (best[1], best[2])
                pred = None
            if pred is not None:
                est, support = pred
                bs_vals = np.asarray(lib.bs_values)
                mtl_vals = np.asarray(lib.mtl_values)
                keep = bs_vals <= self.max_bs
                mtl_keep = mtl_vals[mtl_vals <= self.max_mtl]
                sub = est[keep][:, :len(mtl_keep)]
                sup = support[keep][:, :len(mtl_keep)]
                # a completed row is an ESTIMATE: pin only SUPPORTED points
                # (some pooled observation dominates them) predicted well
                # over the SLO, so estimation error cannot wall off a
                # feasible region permanently
                self._surface = (bs_vals[keep], mtl_keep,
                                 np.where(sup, sub, 0.0))
                self._surface_margin = 1.3
                self.scaler.seed_surface(*self._surface,
                                         margin=self._surface_margin)
                # the 2-D analogue of MTScaler's matrix-completion jump:
                # START at the predicted steady point instead of climbing
                # from (1, 1) — a freshly admitted job otherwise serves a
                # fraction of its demand for the whole climb while its
                # queue (and every queued request's latency) explodes.
                # The jump targets a conservative 0.75*SLO (mean-to-p95
                # slack plus estimation error) and only SUPPORTED points —
                # an unsupported corner is extrapolation, not history.
                # The MTL jump's launch stall is charged by the engine
                # like any other reconfiguration, and a wrong jump is
                # undone by the scaler's gross-violation shrink within a
                # few decisions.
                from repro_torch.serving.device_model import best_feasible_point
                sc = self.scaler
                best = best_feasible_point(
                    np.where(sup, sub, np.inf), bs_vals[keep], mtl_keep,
                    min(sc.alpha, 0.75) * self.slo)
                if best is not None:
                    _, sc.bs, sc.mtl = best
                return
        if hasattr(executor, "price_surface"):
            # 2-D analogue of the matrix-completion seed: price the
            # whole knob grid in ONE vectorized call and pin the
            # model-infeasible frontier before the first probe
            bs_vals = np.arange(1, self.max_bs + 1)
            mtl_vals = np.arange(1, self.max_mtl + 1)
            lat = executor.price_surface(bs_vals, mtl_vals)
            self._surface = (bs_vals, mtl_vals, lat)
            self.scaler.seed_surface(bs_vals, mtl_vals, lat)
        if model_start is not None:
            self.scaler.bs, self.scaler.mtl = model_start

    @property
    def approach(self) -> str:
        if self.mode == "auto":
            return self.profile.approach
        return "H" if self.mode == "hybrid" else self.mode

    def set_slo(self, slo_s: float) -> None:
        changed = slo_s != self.slo
        self.slo = slo_s
        self.scaler.set_slo(slo_s)
        if changed and getattr(self, "_surface", None) is not None:
            # set_slo cleared all pins; re-derive the infeasible frontier
            # for the new SLO from the already-priced surface (no re-pricing)
            self.scaler.seed_surface(*self._surface,
                                     margin=getattr(self, "_surface_margin",
                                                    1.0))

    def note_capacity_change(self, executor=None) -> None:
        """The job's device share changed (cluster migration): every pin
        and search bound was learned on a surface that no longer exists.
        Reset the scaler's search state — and this job's shared-surface
        row, whose old-share points would poison the completion — then
        re-seed the frontier from the new executor's pricing (or the
        shared surface library)."""
        sc = self.scaler
        if hasattr(sc, "reset_search"):
            sc.reset_search()
        if executor is not None:
            self.profiler.executor = executor
        if self.surface_library is not None:
            self.surface_library.reset_row(self.surface_key)
        if isinstance(sc, HybridScaler):
            self._seed_scaler_surface(executor if executor is not None
                                      else self.profiler.executor)

    @property
    def probe_count(self) -> int:
        return len(self.probed_points)

    def action(self) -> Action:
        act = self.scaler.action()
        self.probed_points.add((act.bs, act.mtl))
        return act

    def note_share_grant(self, share: float) -> None:
        """The cluster granted (possibly clipped) this job's partition
        share — align the scaler's ladder position with reality."""
        if hasattr(self.scaler, "set_granted_share"):
            self.scaler.set_granted_share(share)

    def note_share_cap(self, share: float) -> None:
        """Device headroom bound for future share requests."""
        if hasattr(self.scaler, "set_share_cap"):
            self.scaler.set_share_cap(share)

    def observe(self, p95: float, result: Optional[dict] = None) -> None:
        if self.surface_library is not None and result is not None:
            st = result.get("step_time")
            if st:
                act = self.scaler.action()   # the point this step served
                self.surface_library.observe(self.surface_key,
                                             act.bs, act.mtl, st,
                                             share=act.share)
        self.scaler.observe(p95, result)


class StaticController:
    name = "static"

    def __init__(self, bs: int = 1, mtl: int = 1):
        self.bs = bs
        self.mtl = mtl

    def set_slo(self, slo_s: float) -> None:
        pass

    def action(self) -> Action:
        return Action(bs=self.bs, mtl=self.mtl)

    def observe(self, p95: float, result: Optional[dict] = None) -> None:
        pass


__all__ = ["DNNScalerController", "ClipperController", "StaticController",
           "HybridScaler", "ALPHA"]
