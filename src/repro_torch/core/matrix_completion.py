"""Matrix completion for MTL->latency estimation (paper §3.3.2).

The paper profiles latency at MTL=1 and MTL=8 only, then recovers the full
latency curve over MTL in [1, N] with SVD-based matrix completion (they use
TFOCS convex optimization; we solve the same nuclear-norm relaxation with
soft-impute — iterative singular-value thresholding, Mazumder et al. 2010).

The matrix M has one row per *job* (a library of previously profiled jobs
plus the current one) and one column per MTL in 1..N.  Rows are normalized by
their MTL=1 latency so the low-rank structure captures scaling-curve shapes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def soft_impute(M: np.ndarray, mask: np.ndarray, *, lam: float = 0.05,
                rank: Optional[int] = None, iters: int = 300,
                tol: float = 1e-6) -> np.ndarray:
    """Fill missing entries (mask==False) of M via iterative SVD thresholding.

    lam is the singular-value shrinkage (relative to the largest sv);
    rank optionally hard-truncates.
    """
    M = np.asarray(M, dtype=np.float64)
    mask = np.asarray(mask, dtype=bool)
    X = np.where(mask, M, 0.0)
    col_mean = np.where(mask.any(0), (M * mask).sum(0) / np.maximum(mask.sum(0), 1), 0.0)
    X = np.where(mask, M, np.broadcast_to(col_mean, M.shape))

    prev = X.copy()
    for _ in range(iters):
        U, s, Vt = np.linalg.svd(X, full_matrices=False)
        thr = lam * s[0] if s.size else 0.0
        s_shrunk = np.maximum(s - thr, 0.0)
        if rank is not None:
            s_shrunk[rank:] = 0.0
        Xlr = (U * s_shrunk) @ Vt
        X = np.where(mask, M, Xlr)
        delta = np.linalg.norm(X - prev) / max(np.linalg.norm(prev), 1e-12)
        prev = X.copy()
        if delta < tol:
            break
    return X


class SurfaceLibrary:
    """Cross-job shared (bs, mtl) latency surface (2-D analogue of §3.3.2).

    Every job's probed (bs, mtl) step-latency points land in one jobs x
    knobs matrix (rows = serving tenancies, columns = the flattened
    (bs, mtl) grid).  Rows are normalized by the job's (bs=1, mtl=1)
    latency — the paper's §3.3.2 scheme — so the low-rank structure
    captures scaling-curve *shapes* across architecturally similar jobs
    rather than absolute speeds (which also makes rows comparable across
    device shares).  `soft_impute` completes the matrix; `predict` returns
    a newly admitted job's full de-normalized surface so its HybridScaler
    can seed dominance pins from history instead of the analytic floor,
    and so re-placement can anticipate its hybrid steady state."""

    def __init__(self, bs_values: tuple = (1, 2, 4, 8, 16, 32, 64, 128),
                 max_mtl: int = 10, *, min_rows: int = 1,
                 min_points: int = 2, rank: int = 3, loo_tol: float = 0.3,
                 sim_tol: float = 0.25, max_sim_rows: int = 6,
                 share_values: tuple = (1.0,)):
        self.bs_values = tuple(int(b) for b in bs_values)
        self.mtl_values = tuple(range(1, max_mtl + 1))
        # spatial-partition knob grid (serving/partition.py share ladder),
        # stored DESCENDING so latency is monotone non-decreasing along
        # all three axes (bs up, mtl up, share DOWN) — the monotone prior
        # and the dominance support mask then treat every axis alike.
        # The default single-rung grid keeps the library exactly 2-D:
        # arrays, persistence, and predictions are bit-identical to the
        # pre-partition library.
        self.share_values = tuple(sorted((float(s) for s in share_values),
                                         reverse=True))
        self.min_rows = min_rows          # similar rows needed to predict
        self.min_points = min_points      # observed points the target needs
        self.rank = rank
        self.loo_tol = loo_tol            # leave-one-out relative error gate
        self.sim_tol = sim_tol            # shared-support similarity gate
        self.max_sim_rows = max_sim_rows  # completion uses the k best rows
        self._bs_idx = {b: i for i, b in enumerate(self.bs_values)}
        self._sum: dict = {}              # key -> self.shape latency sums
        self._cnt: dict = {}              # key -> self.shape sample counts
        self._version: dict = {}          # key -> bumped on every change
        self._pred_cache: dict = {}       # key -> (versions-fingerprint, est)
        self.observations = 0             # on-grid points recorded (total)
        self.last_reject = None           # why the library tier said None:
        #                                   "points" | "base" | "rows" |
        #                                   "loo" | "share" (drives load-time
        #                                   eviction in the cross-run store)
        self.last_tier = None             # which tier served the last
        #                                   predict(): "library" | "model"
        self._cost_model = None           # perf.cost_model.CostModel prior
        self._features = {}               # key -> ModelFeatures (or None)

    # -- zero-probe prior (perf/cost_model.py third tier) -------------------
    def set_cost_model(self, model) -> None:
        """Attach the learned HLO cost model; `predict` then falls back to
        its zero-probe surface when similarity refuses."""
        self._cost_model = model

    def register_features(self, key, feat) -> None:
        """Remember a tenancy's architecture features (None is remembered
        too, so a featureless job is not re-derived every predict)."""
        self._features[key] = feat

    def has_features(self, key) -> bool:
        return key in self._features

    @property
    def shape(self) -> tuple:
        if len(self.share_values) == 1:
            return len(self.bs_values), len(self.mtl_values)
        return (len(self.bs_values), len(self.mtl_values),
                len(self.share_values))

    def share_index(self, share) -> Optional[int]:
        """Grid index of a share rung (None = the largest rung / off-grid
        values are rejected, mirroring the bs grid)."""
        if share is None:
            return 0
        for s, v in enumerate(self.share_values):
            if abs(v - float(share)) <= 1e-9:
                return s
        return None

    def observe(self, key, bs: int, mtl: int, latency_s: float,
                share=None) -> None:
        """Record one probed step latency.  Off-grid (bs, mtl, share)
        points are dropped — the scalers' doubling/AIMD/ladder moves keep
        probes on the power-of-two x small-integer x rung grid, so
        coverage stays dense."""
        i = self._bs_idx.get(int(bs))
        j = int(mtl) - 1
        s = self.share_index(share)
        if i is None or s is None or not 0 <= j < len(self.mtl_values):
            return
        if not np.isfinite(latency_s) or latency_s <= 0.0:
            return
        if key not in self._sum:
            self._sum[key] = np.zeros(self.shape)
            self._cnt[key] = np.zeros(self.shape, dtype=np.int64)
        ix = (i, j) if len(self.share_values) == 1 else (i, j, s)
        self._sum[key][ix] += float(latency_s)
        self._cnt[key][ix] += 1
        self._version[key] = self._version.get(key, 0) + 1
        self.observations += 1

    def n_points(self, key) -> int:
        cnt = self._cnt.get(key)
        return int((cnt > 0).sum()) if cnt is not None else 0

    def reset_row(self, key) -> None:
        """Drop a tenancy's accumulated points.  Called when its device
        share changes: latencies probed on the old share would otherwise
        be averaged with the new share's and poison the row."""
        self._sum.pop(key, None)
        self._cnt.pop(key, None)
        self._version[key] = self._version.get(key, 0) + 1

    def row(self, key) -> tuple:
        """(mean-latency grid, observed mask) for one tenancy."""
        cnt = self._cnt[key]
        mask = cnt > 0
        mean = np.where(mask, self._sum[key] / np.maximum(cnt, 1), 0.0)
        return mean, mask

    def export_row(self, key) -> Optional[tuple]:
        """(latency-sum grid, sample-count grid) copies for persistence,
        or None for an unknown key."""
        if key not in self._sum:
            return None
        return self._sum[key].copy(), self._cnt[key].copy()

    def import_row(self, key, sum_, cnt) -> bool:
        """Install a persisted row (e.g. a prior run's tenancy reloaded
        from the profile store).  Grid-shape and sanity checked; merges
        into an existing row of the same key.  Returns False (and imports
        nothing) on malformed input."""
        try:
            sum_ = np.asarray(sum_, np.float64)
            cnt = np.asarray(cnt, np.int64)
        except (TypeError, ValueError):
            return False
        if sum_.shape != self.shape or cnt.shape != self.shape:
            return False
        if (cnt < 0).any() or not np.isfinite(sum_).all():
            return False
        mask = cnt > 0
        if (sum_[mask] <= 0).any():
            return False
        if key not in self._sum:
            self._sum[key] = np.zeros(self.shape)
            self._cnt[key] = np.zeros(self.shape, dtype=np.int64)
        self._sum[key] += np.where(mask, sum_, 0.0)
        self._cnt[key] += cnt
        self._version[key] = self._version.get(key, 0) + 1
        self.observations += int(mask.sum())
        return True

    def _base_flat(self, mask_flat) -> Optional[int]:
        """Flat index of the row's normalizer: the (bs=1, mtl=1) point at
        the LARGEST observed share rung (rung 0 is the largest because the
        share grid is stored descending; with the default single-rung grid
        this is exactly the old (1, 1) requirement)."""
        for s in range(len(self.share_values)):
            if mask_flat[s]:
                return s
        return None

    def predict(self, key, share=None, allow_model=True) -> Optional[tuple]:
        """(mean-latency surface, support mask) for `key`, served by the
        first tier that can answer:

          1. similarity fold-in (`_predict_library`) — completed from
             architecturally similar probed history, support = dominance;
          2. the learned HLO cost model (``set_cost_model``) — a
             ZERO-PROBE prior priced from architecture features alone,
             with an all-False support mask: downstream dominance pins,
             surface jumps, and capacity promises all key on support, so
             the prior can seed but never promise.  ``allow_model=False``
             restricts to tier 1 (the profile store's load-time LOO
             validation must judge the library, not the prior).

        `last_tier` records which tier answered ("library" | "model");
        `last_reject` always reports the LIBRARY tier's refusal reason.
        """
        result = self._predict_library(key)
        if result is not None:
            self.last_tier = "library"
            return self._slice_result(result, share)
        self.last_tier = None
        if not allow_model or self._cost_model is None:
            return None
        feat = self._features.get(key)
        if feat is None:
            return None
        est = np.asarray(self._cost_model.predict_surface(
            feat, self.bs_values, self.mtl_values, self.share_values),
            np.float64).reshape(self.shape)
        if not np.isfinite(est).all() or (est <= 0).any():
            return None
        self.last_tier = "model"
        return self._slice_result(
            (est, np.zeros(self.shape, dtype=bool)), share)

    def _predict_library(self, key) -> Optional[tuple]:
        """The similarity tier: (completed mean-latency surface, support
        mask) for `key`, the surface de-normalized by the job's own
        observed (1, 1) point.
        None until the target has its (1, 1) normalizer plus `min_points`
        observations and the library holds `min_rows` similar tenancies
        (too little history would let one noisy row poison permanent
        dominance pins downstream).  With a multi-rung share grid the
        completed object is the full (bs, mtl, share) tensor; the caller
        (`predict`) slices 2-D (bs, mtl) views per share rung.

        The §3.3.2 premise is SIMILARITY, so the completion does not pool
        every tenancy: library rows are first ranked by agreement with the
        target on the shared support of their observed (normalized) points
        and only rows within `sim_tol` median relative error join the
        matrix — a recurring architecture's earlier tenancy matches almost
        exactly; an unrelated job's row does not.  The result is then
        leave-one-out validated: each of the target's observed off-base
        points is held out in turn and must be recovered within `loo_tol`
        relative error.  A job with no architecturally similar history
        gets None instead of a fabricated surface."""
        self.last_reject = "points"
        if self.n_points(key) < max(self.min_points, 1):
            return None
        mean, mask = self.row(key)
        t_mask = np.ravel(mask)
        base = self._base_flat(t_mask)
        if base is None:
            self.last_reject = "base"
            return None                   # need the normalizer
        t_norm = np.ravel(mean) / np.ravel(mean)[base]
        others = []
        for k in self._sum:
            if k == key or self.n_points(k) < 2:
                continue
            m, obs = self.row(k)
            r_mask = np.ravel(obs)
            rbase = self._base_flat(r_mask)
            if rbase is None:
                continue
            r_norm = np.ravel(m) / np.ravel(m)[rbase]
            shared = np.nonzero(t_mask & r_mask)[0]
            # base points are 1.0 by construction — no information
            shared = shared[(shared != base) & (shared != rbase)]
            if len(shared) < 2:
                continue                  # not enough overlap to judge
            err = float(np.median(np.abs(r_norm[shared] - t_norm[shared])
                                  / np.maximum(np.abs(t_norm[shared]),
                                               1e-12)))
            if err <= self.sim_tol:
                others.append((err, k, r_norm, r_mask))
        if len(others) < self.min_rows:
            self.last_reject = "rows"
            return None
        others.sort(key=lambda e: e[0])
        others = others[:self.max_sim_rows]
        fingerprint = (tuple(k for _, k, _, _ in others),
                       self._version.get(key, 0),
                       sum(self._version.get(k, 0) for _, k, _, _ in others))
        cached = self._pred_cache.get(key)
        if cached is not None and cached[0] == fingerprint:
            self.last_reject = cached[2] if len(cached) > 2 else None
            return cached[1]
        # complete in LOG space: latency surfaces are near-multiplicative
        # families (host x batch x tenancy factors), so their logs are
        # genuinely low-rank — and the 3-orders-of-magnitude dynamic range
        # of the linear surface would otherwise let the singular-value
        # shrinkage crush the few small observed anchors of a sparse row.
        # The LIBRARY matrix (dense-ish rows) is completed by soft_impute;
        # the target row is then FOLDED IN by ridge-regressing its few
        # observed anchors onto the library's principal components —
        # running the sparse target row through the iterative thresholding
        # itself would let the shrinkage compound on its ~95% free entries
        # and collapse them toward zero.
        lib_rows = np.vstack([np.log(np.maximum(r, 1e-12))
                              for _, _, r, _ in others])
        lib_mask = np.vstack([m for _, _, _, m in others])
        if not lib_mask.all():
            lib_rows = soft_impute(lib_rows, lib_mask,
                                   rank=min(self.rank, lib_rows.shape[0]))
        r_basis = min(self.rank, lib_rows.shape[0])
        _, _, Vt = np.linalg.svd(lib_rows, full_matrices=False)
        basis = Vt[:r_basis]                  # (r, knobs), uncentered
        t_log = np.log(np.maximum(t_norm, 1e-12))

        def complete(target_mask) -> np.ndarray:
            obs = np.nonzero(target_mask)[0]
            A = basis[:, obs].T               # (n_obs, r)
            b = t_log[obs]
            ridge = 1e-6 * np.eye(r_basis)
            coef = np.linalg.solve(A.T @ A + ridge, A.T @ b)
            return np.exp(coef @ basis)

        # leave-one-out gate on the target's off-base observations
        holdouts = [ix for ix in np.nonzero(t_mask)[0] if ix != base]
        for ix in holdouts:
            loo = t_mask.copy()
            loo[ix] = False
            pred = complete(loo)[ix]
            actual = t_norm[ix]
            if abs(pred - actual) > self.loo_tol * abs(actual):
                self.last_reject = "loo"
                self._pred_cache[key] = (fingerprint, None, "loo")
                return None

        est = complete(t_mask).reshape(self.shape)
        est = np.maximum(est, 1e-9)
        # physical prior: latency is monotone along every knob axis (the
        # share axis is stored descending, so it points the same way)
        for ax in range(est.ndim):
            est = np.maximum.accumulate(est, axis=ax)
        est = est * np.ravel(mean)[base]
        # support: a grid point is trustworthy only if SOME pooled
        # observation dominates it (component-wise >=) — latency
        # monotonicity then upper-bounds it by a measured value.  Corners
        # beyond every observation are pure extrapolation; callers must
        # not jump to, pin, or promise capacity at unsupported points.
        pooled = t_mask.reshape(self.shape).copy()
        for m in lib_mask:
            pooled |= m.reshape(self.shape)
        support = pooled
        for ax in range(support.ndim):
            support = np.flip(np.maximum.accumulate(
                np.flip(support, ax), axis=ax), ax)
        result = (est, support)
        self.last_reject = None
        self._pred_cache[key] = (fingerprint, result, None)
        return result

    def _slice_result(self, result, share):
        """The (bs, mtl) view of a prediction at one share rung (the full
        object — 2-D, or the whole tensor — when `share` is None).  An
        unknown/off-grid rung returns None with `last_reject = "share"` —
        distinct from the no-history rejections, so callers can tell a
        bad rung apart from a cold library."""
        if result is None or share is None or len(self.share_values) == 1:
            return result
        s = self.share_index(share)
        if s is None:
            self.last_reject = "share"
            self.last_tier = None
            return None
        est, support = result
        return est[:, :, s], support[:, :, s]


class LatencyEstimator:
    """Estimates latency(MTL) for a new job from two profiled points plus a
    library of fully-profiled historical jobs."""

    def __init__(self, max_mtl: int = 10):
        self.max_mtl = max_mtl
        self.library: list[np.ndarray] = []   # normalized rows, len max_mtl

    def add_library_row(self, latencies_by_mtl: dict) -> None:
        row = np.array([latencies_by_mtl[m] for m in range(1, self.max_mtl + 1)],
                       dtype=np.float64)
        self.library.append(row / row[0])

    def estimate(self, observed: dict) -> np.ndarray:
        """observed: {mtl: latency_s} (the paper uses {1: ..., 8: ...}).

        Returns estimated latency for MTL = 1..max_mtl (seconds)."""
        assert 1 in observed, "need the MTL=1 point for normalization"
        base = observed[1]
        row = np.zeros(self.max_mtl)
        mask_row = np.zeros(self.max_mtl, dtype=bool)
        for m, lat in observed.items():
            if 1 <= m <= self.max_mtl:
                row[m - 1] = lat / base
                mask_row[m - 1] = True

        if self.library:
            M = np.vstack(self.library + [row])
            mask = np.vstack([np.ones_like(r, dtype=bool) for r in self.library]
                             + [mask_row])
            filled = soft_impute(M, mask, rank=min(3, M.shape[0]))
            est = filled[-1]
        else:
            # no library: fall back to linear interpolation/extrapolation in MTL
            ms = np.array(sorted(observed))
            vals = np.array([observed[m] / base for m in ms])
            est = np.interp(np.arange(1, self.max_mtl + 1), ms, vals)
            if len(ms) >= 2:  # extrapolate past the last observation
                slope = (vals[-1] - vals[0]) / (ms[-1] - ms[0])
                for i in range(self.max_mtl):
                    m = i + 1
                    if m > ms[-1]:
                        est[i] = vals[-1] + slope * (m - ms[-1])
        est = np.maximum(est, 1e-9)
        # physical prior: co-locating more instances never reduces latency
        est = np.maximum.accumulate(est)
        return est * base

    def pick_mtl(self, observed: dict, slo_s: float) -> tuple[int, np.ndarray]:
        """Largest MTL whose estimated latency is below the SLO (Alg. 1 l.32)."""
        est = self.estimate(observed)
        ok = [m for m in range(1, self.max_mtl + 1) if est[m - 1] < slo_s]
        return (max(ok) if ok else 1), est
