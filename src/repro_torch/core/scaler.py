"""Scaler module (paper §3.2.2, Algorithm 1 lines 10-41) plus a joint knob.

BatchScaler — pseudo binary search over batch size in [1, maxBS] with the
hysteresis band [alpha*SLO, SLO] (alpha = 0.85); dynamic batch sizing means
changes are free.  MTScaler — jump to the matrix-completion-estimated MTL,
then AIMD (+1 under alpha*SLO, -1 over SLO).  HybridScaler — beyond the
paper: coordinate descent over the joint (BS, MTL) grid (see its docstring).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from repro_torch.serving.engine import Action

ALPHA = 0.85


class BatchScaler:
    """Algorithm 1, lines 10-29."""

    def __init__(self, slo_s: float, *, max_bs: int = 128, alpha: float = ALPHA,
                 decision_interval: int = 5):
        self.slo = slo_s
        self.alpha = alpha
        self.min_bs = 1
        self.max_bs = max_bs
        self.bs = 1
        self.hard_max = max_bs
        self.decision_interval = decision_interval
        self._steps = 0
        self.infeasible = False
        self.converged_steps = 0
        self._viol_streak = 0   # paper §4.4: short-lived spikes are skipped;
                                # only persistent violations trigger descent
        # Damping beyond the paper: when no batch size lands inside the
        # [alpha*SLO, SLO] band, Algorithm 1 as written oscillates between the
        # last feasible BS and the smallest infeasible one; remembering the
        # infeasible point pins the search at the feasible neighbour.
        self._known_bad: Optional[int] = None

    def set_slo(self, slo_s: float) -> None:
        if slo_s != self.slo:
            self.slo = slo_s
            self.reset_search()

    def reset_search(self) -> None:
        """Re-open the search bounds (SLO change — paper §4.5 — or a
        device-share change under cluster migration)."""
        self.min_bs, self.max_bs = 1, self.hard_max
        self._known_bad = None
        self.infeasible = False

    def action(self) -> Action:
        return Action(bs=self.bs, mtl=1)

    def observe(self, p95: float, result: Optional[dict] = None) -> None:
        self._steps += 1
        if self._steps % self.decision_interval:
            return
        if self.converged_steps >= 12:
            # a known-bad point may have been a transient spike — allow the
            # search to re-probe upward after a long stable stretch
            self._known_bad = None
            self.converged_steps = 0
        if self.alpha * self.slo <= p95 <= self.slo:
            self.converged_steps += 1
            self._viol_streak = 0
            return                                        # line 13-14
        if p95 < self.alpha * self.slo:                   # line 15-18
            self._viol_streak = 0
            if self.bs == self.hard_max:
                return                # largest possible: no further gain
            self.min_bs = self.bs
            cand = min(math.ceil((self.min_bs + self.max_bs) / 2),
                       self.hard_max)
            if self._known_bad is not None and cand >= self._known_bad:
                cand = self._known_bad - 1
            if cand <= self.bs:
                self.converged_steps += 1
                return
            self.bs = cand
        else:                                             # line 19-29
            self._viol_streak += 1
            if self._viol_streak < 2:
                return                # skip short-lived spikes (paper §4.4)
            self._known_bad = self.bs if self._known_bad is None else \
                min(self._known_bad, self.bs)
            if self.bs == 1:
                self.infeasible = True                    # line 20-21
                return
            if self.bs == self.min_bs:                    # line 22-25
                self.max_bs = self.bs
                self.min_bs = 1
                self.bs = max(math.floor((self.min_bs + self.max_bs) / 2), 1)
            else:                                         # line 26-29
                self.max_bs = self.bs
                self.bs = max(math.floor((self.min_bs + self.max_bs) / 2), 1)
        self.converged_steps = 0


class MTScaler:
    """Algorithm 1, lines 30-41: matrix-completion jump + AIMD refinement."""

    def __init__(self, slo_s: float, estimator, observed: dict, *,
                 max_mtl: int = 10, alpha: float = ALPHA,
                 decision_interval: int = 5):
        self.slo = slo_s
        self.alpha = alpha
        self.max_mtl = max_mtl
        self.estimator = estimator
        self.observed = dict(observed)
        self.mtl, self.estimate = estimator.pick_mtl(observed, slo_s)  # line 31-32
        self.mtl = max(1, min(int(self.mtl), max_mtl))
        self.decision_interval = decision_interval
        self._steps = 0
        self.converged_steps = 0
        self._viol_streak = 0
        self._known_bad: Optional[int] = None   # oscillation damping (see
                                                # BatchScaler)

    def set_slo(self, slo_s: float) -> None:
        if slo_s != self.slo:
            self.reset_search()
        self.slo = slo_s

    def reset_search(self) -> None:
        self._known_bad = None

    def action(self) -> Action:
        return Action(bs=1, mtl=self.mtl)

    def observe(self, p95: float, result: Optional[dict] = None) -> None:
        self._steps += 1
        if self._steps % self.decision_interval:
            return
        if self.converged_steps >= 12:
            self._known_bad = None    # transient-spike amnesty (see above)
            self.converged_steps = 0
        if self.alpha * self.slo <= p95 <= self.slo:      # line 34-35
            self.converged_steps += 1
            self._viol_streak = 0
            return
        if p95 < self.alpha * self.slo:                   # line 36-38
            self._viol_streak = 0
            nxt = self.mtl + 1
            if nxt <= self.max_mtl and nxt != self._known_bad:
                self.mtl = nxt
                self.converged_steps = 0
            else:
                self.converged_steps += 1
        elif p95 > self.slo:                              # line 39-41
            self._viol_streak += 1
            if self._viol_streak < 2:
                return                # skip short-lived spikes (paper §4.4)
            self._known_bad = self.mtl
            if self.mtl > 1:
                self.mtl -= 1
                self.converged_steps = 0


class HybridScaler:
    """Joint (BS, MTL) scaler — 2-D coordinate descent (beyond the paper).

    The paper's Algorithm 1 commits to ONE knob after profiling, but related
    work (D-STACK's spatio-temporal multiplexing; the multi-tenant inference
    survey's hybrid-knob taxonomy) shows the knobs compose: co-located
    instances each running batched inference can dominate either pure
    strategy.  HybridScaler searches the joint grid:

      * seed: the profiler's winning axis is the `primary` knob.  "MT"
        jumps straight to the matrix-completion MTL estimate at BS=1 (like
        MTScaler, so the expensive instance launches happen once); "B"
        starts at (1, 1) like BatchScaler;
      * coordinate descent under the same [alpha*SLO, SLO] hysteresis band.
        Inside the band nothing moves.  With slack, the primary knob grows
        first — BS doubles geometrically (free under dynamic batch sizing;
        doubling, not a midpoint jump, bounds the overshoot of a probe to
        2x the last feasible point, which matters when the other knob is
        already high and each step is expensive), MTL climbs +1 (AIMD,
        costs a launch stall).  Once the primary is saturated, the
        secondary knob grows the same way;
      * persistent violations first UNDO a freshly made move exactly, then
        shrink BS (one notch when the point was long-held — that's noise
        or a load shift — halving during active search), then shed
        instances; a gross violation (p95 > spike_guard * SLO) is acted on
        immediately — at cluster scale a mis-probe can cost whole seconds
        per step, so waiting out the paper's two-decision spike filter is
        itself expensive.  `infeasible` is only reachable at (BS=1, MTL=1);
      * the 1-D known-bad damping generalizes to a dict of pinned (BS, MTL)
        points with a decision-count amnesty window — a pinned point is
        never re-probed before the window expires.  Unlike 1-D (where the
        hysteresis band leaves a converged scaler with nowhere to probe),
        a 2-D search converged BELOW the band always has an orthogonal
        direction left, so amnesty alone would re-probe the same bad
        neighbours forever.  A *probe-target* pin (a deliberate move that
        failed) struck `persist_pins` times becomes permanent and prunes
        its whole upper-right quadrant (latency is monotone in both
        knobs); occupancy pins — the point we were sitting on when noise
        or load shifted — never persist, or noise alone would eventually
        ratchet every good point out of the search space;
      * measurements are judged carefully: after any move the tail window
        is reset, so p95 readings cool down until the window refills
        (`min_eval_samples`), and growth in refine mode (once a BS ceiling
        is known) waits for two consecutive slack readings — near the band
        edge a single below-band wobble is usually noise, and the probe it
        would trigger is served at over-SLO latency;
      * with a `share_ladder` (spatial partitioning — serving/partition.py)
        the search gains a THIRD coordinate-descent axis over discrete
        device-share rungs: share-up is the tertiary growth move (and the
        violation escape at the (1, 1) floor, before `infeasible`),
        share-down is probed under deep slack to hand capacity back to the
        cluster.  Share moves ride the same pending/revert machinery as
        the knob moves (throughput-guarded, so a share-up that demand
        cannot use is reverted), pins become (bs, mtl, rung) triples, and
        dominance extends along the new axis: latency is monotone
        DECREASING in share, so a persistent failure at (b0, m0, s0)
        prunes bs >= b0, mtl >= m0 at every share <= s0.  The cluster
        mediates actual grants (`set_granted_share` / `set_share_cap`);
      * latency slack alone is NOT a go signal in 2-D: host-bound jobs lose
        throughput as BS grows even while p95 stays under the SLO (the
        rho(BS) copy-pressure term).  Every growth move is therefore
        validated against the interval throughput it actually delivered;
        a move that reduced throughput by more than `revert_tol` is
        reverted and its target pinned.  MTL probes on the secondary axis
        must also pass an amortization gate: a launch stall of
        `mtl_move_cost_s` can never pay off for a job whose whole decision
        interval serves less than a tenth of that.
    """

    def __init__(self, slo_s: float, estimator=None, observed: dict = None,
                 *, primary: str = "B", max_bs: int = 128, max_mtl: int = 10,
                 alpha: float = ALPHA, decision_interval: int = 5,
                 amnesty: int = 20, revert_tol: float = 0.05,
                 spike_guard: float = 1.5, persist_pins: int = 2,
                 mtl_move_cost_s: float = 2.0, min_eval_samples: int = 60,
                 safety: float = 0.0, share_ladder=None, pool_ladder=None):
        self.slo = slo_s
        self.alpha = alpha
        self.primary = primary
        self.hard_max_bs = max_bs
        self.max_mtl = max_mtl
        self.decision_interval = decision_interval
        self.amnesty = amnesty
        self.revert_tol = revert_tol
        self.spike_guard = spike_guard
        self.persist_pins = persist_pins
        self.mtl_move_cost_s = mtl_move_cost_s
        self.min_eval_samples = min_eval_samples
        # optional margin on the internal latency target ((1-safety)*SLO)
        # for deployments that want headroom below the hard SLO; off by
        # default — on the Table-4 trace it shifted search trajectories
        # more than it bought compliance (measured in the cluster bench)
        self.safety = safety
        self.refine_gate = True   # require 2 slack readings in refine mode
        # third coordinate-descent axis (spatial partitioning): a discrete
        # ladder of device shares the scaler may request.  The CLUSTER
        # grants shares (legality: co-resident shares sum <= 1) — the
        # scaler requests; `set_granted_share` aligns it with the grant and
        # `set_share_cap` bounds requests by the device's headroom.  None
        # keeps the scaler exactly 2-D (every pin key carries a constant
        # share index, so behavior is bit-identical to the 2-D search).
        self.share_ladder = (tuple(sorted(float(s) for s in share_ladder))
                             if share_ladder else None)
        self._share_idx = (len(self.share_ladder) - 1
                           if self.share_ladder else 0)
        self._share_value = None       # off-ladder grant currently held
        self._share_cap_idx = self._share_idx
        # fourth axis (disaggregated serving): a ladder of prefill-pool
        # ratios — prefill devices per decode device.  Demand-capped like
        # the share axis: `note_pool_demand` bounds requests by the
        # measured prefill load, `observe_pool` grows under queue pressure
        # and releases rungs the demand no longer covers.  None keeps the
        # scaler exactly as before (no pool state is ever consulted).
        self.pool_ladder = (tuple(sorted(float(r) for r in pool_ladder))
                            if pool_ladder else None)
        self._pool_idx = (len(self.pool_ladder) - 1
                          if self.pool_ladder else 0)
        self._pool_cap_idx = self._pool_idx
        self.bs = 1
        self.estimate = None
        if primary == "MT" and estimator is not None and observed:
            mtl, self.estimate = estimator.pick_mtl(observed, slo_s)
            self.mtl = max(1, min(int(mtl), max_mtl))
        else:
            self.mtl = 1
        self.infeasible = False
        self.converged_steps = 0
        self._steps = 0
        self._decisions = 0
        self._viol_streak = 0
        self._slack_streak = 0
        self._known_bad: dict = {}     # (bs, mtl) -> decision index pinned
        self._dom_counts: dict = {}    # probe-target pins (dominance-safe)
        self._hi = max_bs              # BS ceiling (violation-tightened)
        self._pending = None           # ((bs, mtl), thr) state before move
        self._int_items = 0
        self._int_time = 0.0
        self._last_int_time = 0.0      # seconds of serving per decision
        self._move_decision = -10      # decision index of the last move
        self._samples_since_move = 10**9

    def set_slo(self, slo_s: float) -> None:
        if slo_s != self.slo:
            # re-open the whole 2-D search on SLO change (paper §4.5)
            self.reset_search()
        self.slo = slo_s

    def reset_search(self) -> None:
        """Forget every learned feasibility boundary: pins, the BS ceiling,
        and any pending probe.  Called on SLO change and when the job's
        device share changes (cluster migration) — the surface the pins
        were learned on no longer exists."""
        self._known_bad.clear()
        self._dom_counts.clear()
        self._hi = self.hard_max_bs
        self._pending = None
        self.infeasible = False
        self._viol_streak = 0
        self._slack_streak = 0
        self.converged_steps = 0

    def action(self) -> Action:
        return Action(bs=self.bs, mtl=self.mtl, share=self.share)

    # -- third axis: partition share ----------------------------------------
    @property
    def share(self):
        if self.share_ladder is None:
            return None
        if self._share_value is not None:
            return self._share_value    # holding an off-ladder grant
        return self.share_ladder[self._share_idx]

    def _rung_at_most(self, share: float) -> int:
        idx = 0
        for i, r in enumerate(self.share_ladder):
            if r <= share + 1e-9:
                idx = i
        return idx

    def set_granted_share(self, share: float) -> None:
        """Align with the cluster's actual grant (it may clip a request to
        the device's headroom, shrink the slice at an admission, or grant
        an off-ladder value like 1/3).  The scaler KEEPS reporting the
        granted value until it deliberately moves — snapping the report
        down to a rung would make the engine read the difference as a
        shrink request and charge a spurious resize one step later."""
        if self.share_ladder is None:
            return
        self._share_idx = self._rung_at_most(share)
        self._share_value = (None if abs(
            share - self.share_ladder[self._share_idx]) <= 1e-9 else share)

    def set_share_cap(self, share: float) -> None:
        """Bound future share requests by the device's current headroom."""
        if self.share_ladder is None:
            return
        self._share_cap_idx = self._rung_at_most(share)

    # -- fourth axis: prefill-pool ratio ------------------------------------
    @property
    def pool_ratio(self):
        if self.pool_ladder is None:
            return None
        return self.pool_ladder[self._pool_idx]

    def note_pool_demand(self, demand_ratio: float) -> None:
        """Demand-cap the pool axis: `demand_ratio` is the measured
        prefill load in device-seconds per second per decode device, so
        the smallest rung COVERING it is the largest pool worth holding —
        rungs above it would only idle prefill silicon.  Mirrors
        `set_share_cap` on the share axis."""
        if self.pool_ladder is None:
            return
        cap = len(self.pool_ladder) - 1
        for i, r in enumerate(self.pool_ladder):
            if r >= demand_ratio - 1e-9:   # first rung that covers demand
                cap = i
                break
        self._pool_cap_idx = cap

    def observe_pool(self, prefill_wait_s: float, ttft_slo_s: float) -> bool:
        """One pool-axis decision.  Releases a rung when the ratio sits
        above the demand cap (prefill silicon the load cannot keep busy),
        grows one when p95 prefill+transfer wait eats more than half the
        TTFT budget and the cap allows it.  Returns True when the ratio
        changed (the engine then resizes the pool's active membership)."""
        if self.pool_ladder is None:
            return False
        if self._pool_idx > self._pool_cap_idx:
            self._pool_idx -= 1
            return True
        if (prefill_wait_s > 0.5 * ttft_slo_s
                and self._pool_idx < min(self._pool_cap_idx,
                                         len(self.pool_ladder) - 1)):
            self._pool_idx += 1
            return True
        return False

    # -- surface seeding ----------------------------------------------------
    def seed_surface(self, bs_values, mtl_values, latency_s,
                     margin: float = 1.0) -> int:
        """Seed the dominance pins from a priced (bs, mtl) latency surface.

        `latency_s[i, j]` is the estimated MEAN latency at
        (bs_values[i], mtl_values[j]) — e.g. `SimExecutor.price_surface`,
        the 2-D analogue of the matrix-completion MTL curve.  Points whose
        mean already exceeds the SLO can never satisfy p95 <= SLO, so their
        minimal (lower-left) frontier is pinned permanently; dominance
        pruning in `is_pinned` rules out each frontier point's whole
        upper-right quadrant without a single wasted probe.  Also tightens
        the BS ceiling `_hi` at the current MTL.  Returns the number of
        frontier pins installed.

        `margin > 1` is for UNCERTAIN surfaces (a cross-job matrix
        completion rather than the exact analytic price): only points whose
        estimate exceeds margin*SLO are pinned, so a modest estimation
        error cannot permanently wall off a genuinely feasible point."""
        lat = np.asarray(latency_s, np.float64)
        bs_values = [int(b) for b in bs_values]
        mtl_values = [int(m) for m in mtl_values]
        bad = lat > self.slo * margin
        pins = 0
        prev_first = len(bs_values)      # first-bad row of the previous MTL
        for j, m in enumerate(mtl_values):
            rows = np.nonzero(bad[:, j])[0]
            if rows.size == 0:
                continue
            i = int(rows[0])             # latency is monotone in bs: the
            if i < prev_first:           # first bad bs rules the column out
                self._dom_counts[(bs_values[i], m, self._share_idx)] = \
                    self.persist_pins
                pins += 1
                prev_first = i
        # BS ceiling at the MTL we are sitting on (conservative for lower
        # MTLs by monotonicity, exactly like the ceiling kept by _grow_mtl)
        if self.mtl in mtl_values:
            rows = np.nonzero(bad[:, mtl_values.index(self.mtl)])[0]
            if rows.size:
                self._hi = min(self._hi, max(bs_values[int(rows[0])] - 1, 1))
        return pins

    # -- known-bad (3-D, amnesty-windowed) ----------------------------------
    def is_pinned(self, bs: int, mtl: int, si: int = None) -> bool:
        # probe-target pins prune by dominance: latency is monotone
        # increasing in bs and mtl and DECREASING in share, so a probe that
        # persistently failed at (b0, m0, s0) rules out every point with
        # bs >= b0, mtl >= m0 at the same or any SMALLER share.  Occupancy
        # pins (the point we were sitting on when load or noise shifted)
        # and fresh pins block the exact point only — a transient at the
        # steady point must not condemn the whole search space above it.
        # With no share ladder every key carries index 0 and this reduces
        # to the original 2-D dominance exactly.
        if si is None:
            si = self._share_idx
        for (b0, m0, s0), c in self._dom_counts.items():
            if c >= self.persist_pins and b0 <= bs and m0 <= mtl \
                    and si <= s0:
                return True
        # occupancy pins (generic shrinks at a held point) deliberately
        # never become permanent: over a long run, noise alone would strike
        # every good point twice eventually and ratchet the search into a
        # corner — only deliberate, post-cooldown probe verdicts persist
        t = self._known_bad.get((bs, mtl, si))
        return t is not None and self._decisions - t < self.amnesty

    def _pin(self, bs: int, mtl: int, dominant: bool = False,
             si: int = None) -> None:
        if si is None:
            si = self._share_idx
        self._known_bad[(bs, mtl, si)] = self._decisions
        if dominant:
            self._dom_counts[(bs, mtl, si)] = \
                self._dom_counts.get((bs, mtl, si), 0) + 1

    def _mark_move(self) -> None:
        """A knob just changed: the tail window was reset, so its p95 is
        max-dominated (one 2x OS-jitter spike IS the p95 of a near-empty
        window) until enough fresh samples land.  Judgments wait."""
        self._move_decision = self._decisions
        self._samples_since_move = 0

    # -- growth moves -------------------------------------------------------
    def _grow_bs(self) -> bool:
        hi = min(self._hi, self.hard_max_bs)
        if hi >= self.hard_max_bs:
            cand = min(self.bs * 2, hi)     # no ceiling known yet: double
        else:
            # ceiling known: refine by midpoint (like BatchScaler) so that
            # re-probes near the band edge overshoot by a notch, not by 2x
            cand = min(math.ceil((self.bs + hi) / 2), hi)
        while cand > self.bs and self.is_pinned(cand, self.mtl):
            cand = self.bs + (cand - self.bs) // 2   # halve the gap, not -1:
            # a -1 walk would mint a long chain of distinct candidates, each
            # needing its own pins before the search quiets down
        if cand <= self.bs:
            return False
        self.bs = cand
        self._mark_move()
        return True

    def _grow_mtl(self, secondary: bool = False) -> bool:
        nxt = self.mtl + 1
        if nxt > self.max_mtl or self.is_pinned(self.bs, nxt):
            return False
        if secondary and 0 < self._last_int_time < 0.1 * self.mtl_move_cost_s:
            # amortization gate: a speculative instance launch stalls the
            # job for mtl_move_cost_s; for a job whose whole decision
            # interval serves far less than that, the probe can never pay
            # for itself (a 2 s stall is ~600 SLOs for the 3.5 ms jobs)
            return False
        self.mtl = nxt
        # `_hi` is kept: latency is monotone in MTL, so a BS ceiling
        # learned at a lower MTL still bounds the feasible BS here —
        # resetting it would trigger a full doubling re-climb (and its
        # chain of gross overshoots) after every failed MTL probe
        self._mark_move()
        return True

    def _grow_share(self) -> bool:
        """Request the next share rung up (more spatial capacity).  Tried
        when both knob axes are saturated, and as the violation escape at
        the (1, 1) floor — a bigger slice is the only remaining move."""
        if self.share_ladder is None:
            return False
        nxt = self._share_idx + 1
        if nxt > min(self._share_cap_idx, len(self.share_ladder) - 1):
            return False
        if self.is_pinned(self.bs, self.mtl, nxt):
            return False
        if (self._share_value is not None
                and self.share_ladder[nxt] <= self._share_value + 1e-9):
            return False                 # the rung up is not actually more
        self._share_idx = nxt
        self._share_value = None
        self._mark_move()
        return True

    def _shrink_share(self) -> bool:
        """Probe one share rung down: frees cluster capacity.  Only worth
        trying under deep slack; the throughput guard reverts it when the
        smaller slice actually cost served items (closed loop), and keeps
        it when demand was the binding constraint anyway (open loop)."""
        if self.share_ladder is None or self._share_idx == 0:
            return False
        if self.is_pinned(self.bs, self.mtl, self._share_idx - 1):
            return False
        self._share_idx -= 1
        self._share_value = None
        self._mark_move()
        return True

    def _grow(self, allow_secondary: bool) -> bool:
        if self.primary == "MT":
            return (self._grow_mtl()
                    or (allow_secondary and self._grow_bs())
                    or (allow_secondary and self._grow_share()))
        return (self._grow_bs()
                or (allow_secondary and self._grow_mtl(secondary=True))
                or (allow_secondary and self._grow_share()))

    def _shrink(self) -> None:
        """Back off after a persistent/gross violation."""
        self.converged_steps = 0
        if self._pending is not None:
            # the violation is the direct result of the last move: undo it.
            # Dominance applies to bs/mtl/share-down probes (monotone
            # directions); a share-UP probe that 'violated' can only be
            # noise — latency shrinks with share — so pin the exact point
            (pbs, pmtl, psi, pval), _ = self._pending
            self._pin(self.bs, self.mtl,
                      dominant=self._share_idx <= psi)
            self._pending = None
            if self.mtl == pmtl and self.bs > pbs:
                self._hi = self.bs
            self.bs, self.mtl = pbs, pmtl
            self._share_idx, self._share_value = psi, pval
            self._mark_move()
            return
        self._pin(self.bs, self.mtl)
        # a point held for a while that suddenly violates is usually noise
        # or a load shift grazing the band top — step down one notch; only
        # a violation during active search warrants the halving descent
        stable = self._decisions - self._move_decision >= 6
        if self.bs > 1:
            self._hi = self.bs
            cand = self.bs - 1 if stable else max(self.bs // 2, 1)
            while cand > 1 and self.is_pinned(cand, self.mtl):
                cand //= 2
            self.bs = max(cand, 1)
            self._mark_move()
        elif self.mtl > 1:
            self.mtl -= 1
            # keep `_hi`: it is conservative at the lower MTL (the true
            # ceiling there is >= the one learned here); the amnesty
            # relaxation re-opens it gradually if there is room
            self._mark_move()
        elif self._grow_share():
            # (1, 1) still violates: a bigger spatial slice is the one
            # remaining escape before declaring the job infeasible
            return
        else:
            self.infeasible = True

    def observe(self, p95: float, result: Optional[dict] = None) -> None:
        self._steps += 1
        if result is not None:
            self._int_items += result.get("items", 0)
            self._int_time += result.get("step_time", 0.0)
            # the tail window receives at most 64 request samples per step
            self._samples_since_move += min(result.get("items", 64), 64)
        else:
            self._samples_since_move += 64   # no telemetry: assume refilled
        if self._steps % self.decision_interval:
            return
        self._decisions += 1
        thr = self._int_items / self._int_time if self._int_time else None
        self._last_int_time = self._int_time
        self._int_items, self._int_time = 0, 0.0

        # post-move cooldown: the window was reset by the move, so p95 is
        # max-dominated until it refills — freeze judgments (capped at 3
        # decisions so slow big-batch jobs are not stalled forever)
        cooling = (self._samples_since_move < self.min_eval_samples
                   and self._decisions - self._move_decision < 3)
        slo_t = self.slo * (1.0 - self.safety)   # internal target

        guard = max(2.5, self.spike_guard) if cooling else self.spike_guard
        if p95 > slo_t * guard:
            # gross violation: act now, the two-decision spike filter is too
            # slow when a mis-probe costs seconds of serving per step.
            # During cooldown the bar is one spiked sample ABOVE what a
            # healthy point could ever show (spike_mult * band top = 2x).
            self._viol_streak = 0
            self._slack_streak = 0
            self._shrink()
            return
        if cooling:
            return

        if self._pending is not None and p95 <= slo_t:
            (pbs, pmtl, psi, pval), pthr = self._pending
            self._pending = None
            revert = False
            if thr is not None and pthr is not None:
                revert = thr < pthr * (1.0 - self.revert_tol)
                if self._share_idx > psi and not revert:
                    # a share-UP consumes a cluster-wide resource: it must
                    # STRICTLY pay for itself.  A demand-capped job whose
                    # throughput stayed flat hands the slice back.
                    revert = thr <= pthr * (1.0 + self.revert_tol)
            if revert:
                # latency-feasible but throughput-negative: revert + pin.
                # A share-UP probe that bought nothing (demand was the
                # binding constraint) gets an exact-point pin only —
                # dominance along the share axis points the other way
                self._pin(self.bs, self.mtl,
                          dominant=self._share_idx <= psi)
                if self.mtl == pmtl and self.bs > pbs:
                    self._hi = self.bs    # larger BS is worse here: cap it
                self.bs, self.mtl = pbs, pmtl
                self._share_idx, self._share_value = psi, pval
                self._mark_move()
                self.converged_steps = 0
                return

        if self.converged_steps >= self.amnesty:
            # long-stable stretch: pins may have been transient spikes —
            # amnesty re-opens the search (mirrors the 1-D scalers).  The
            # BS ceiling `_hi` relaxes by roughly one notch (~12%), not to
            # the hard max: a steady point at the band edge must re-probe
            # its immediate neighbour, not leap halfway to 2x.
            self._known_bad.clear()
            self._hi = min(self.hard_max_bs,
                           max(self._hi, self.bs + max(1, self.bs // 8)))
            self.converged_steps = 0

        if self.alpha * slo_t <= p95 <= slo_t:
            self.converged_steps += 1
            self._viol_streak = 0
            self._slack_streak = 0
            return
        if p95 < self.alpha * slo_t:
            self._viol_streak = 0
            self._slack_streak += 1
            # any axis needs TWO slack readings once a BS ceiling is known
            # (refine mode): near the band edge a single wobble below the
            # band is usually noise, and every probe it triggers is served
            # at over-SLO latency.  During the initial climb (no ceiling
            # yet) the primary axis moves on the first reading.
            gate = (2 if self.refine_gate and self._hi < self.hard_max_bs
                    else 1)
            prev = (self.bs, self.mtl, self._share_idx, self._share_value)
            if (self._slack_streak >= gate
                    and self._grow(allow_secondary=self._slack_streak >= 2)):
                self._pending = (prev, thr)
                self.converged_steps = 0
            elif (self._slack_streak >= 3
                  and p95 < 0.5 * self.alpha * slo_t
                  and self._shrink_share()):
                # deep slack and nothing left to grow: probe one share rung
                # down — gives capacity back to the cluster; reverted by the
                # throughput guard / violation undo if the slice mattered
                self._pending = (prev, thr)
                self.converged_steps = 0
            else:
                self.converged_steps += 1
            return
        # slo_t < p95 <= spike_guard * slo_t
        self._slack_streak = 0
        if self._pending is not None:
            # the violation follows our own probe: undo it right away —
            # waiting out the spike filter doubles every probe's cost
            self._viol_streak = 0
            self._shrink()
            return
        self._viol_streak += 1
        if self._viol_streak < 2:
            return                    # skip short-lived spikes (paper §4.4)
        self._viol_streak = 0
        self._shrink()
