"""Clipper baseline (Crankshaw et al., NSDI'17) as described in the paper:
AIMD batch-size control — additive +4 while under the SLO, multiplicative
10% back-off on violation.  Batching only, no multi-tenancy."""

from __future__ import annotations

from typing import Optional

from repro_torch.serving.engine import Action


class ClipperController:
    name = "clipper"

    def __init__(self, slo_s: float, *, step: int = 4, backoff: float = 0.10,
                 max_bs: int = 128, decision_interval: int = 5):
        self.slo = slo_s
        self.step = step
        self.backoff = backoff
        self.max_bs = max_bs
        self.bs = 1
        self.decision_interval = decision_interval
        self._steps = 0
        self._held = False   # converged after first violation+backoff; the
                             # additive probe resumes only on large slack
                             # (e.g. an SLO change) — paper Fig. 7 shows
                             # Clipper stabilizing, not sawtoothing.

    def set_slo(self, slo_s: float) -> None:
        if slo_s != self.slo:
            self._held = False
        self.slo = slo_s

    def action(self) -> Action:
        return Action(bs=self.bs, mtl=1)

    def observe(self, p95: float, result: Optional[dict] = None) -> None:
        self._steps += 1
        if self._steps % self.decision_interval:
            return
        if p95 > self.slo:
            self.bs = max(int(self.bs * (1.0 - self.backoff)), 1)
            self._held = True
        elif not self._held or p95 < 0.6 * self.slo:
            self.bs = min(self.bs + self.step, self.max_bs)
            if p95 < 0.6 * self.slo:
                self._held = False
