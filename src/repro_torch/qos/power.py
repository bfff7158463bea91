"""Power-cap governor: NVM dynamic power vs. a configurable budget.

``NvmReport.dynamic_power_mw`` feeds a control loop: the
:class:`~repro_torch.core.memos.MemosManager` feeds the
governor the summed per-wear-tier dynamic power at the end of every
pass; while over budget the governor raises an integer **throttle
level**, and

  * the serving engine shrinks batch admission by one slot per level
    (``batch_limit``) — fewer live rows, fewer slow-tier token writes
    per step;
  * the next memos pass plans under *power pressure*: write-dominated
    pages are steered to the fast tier and intermediate-tier fill ranks
    media by Table-1 access **energy** instead of latency, biasing
    placement toward the low-energy medium.

Recovery is hysteretic: ``recover_passes`` consecutive under-budget
passes release one level, so the cap doesn't oscillate on the pass
boundary.  The loop is deterministic — level changes depend only on the
sequence of per-pass power readings.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class PowerGovernor:
    budget_mw: float
    recover_passes: int = 2
    max_throttle: int = 8

    throttle: int = 0             # current shrink level (0 = cap satisfied)
    last_power_mw: float = 0.0    # most recent per-pass reading
    peak_power_mw: float = 0.0
    over_budget_passes: int = 0
    _calm: int = 0

    def observe(self, power_mw: float) -> bool:
        """Feed one pass's total dynamic power; returns whether this
        reading exceeded the budget."""
        self.last_power_mw = float(power_mw)
        self.peak_power_mw = max(self.peak_power_mw, self.last_power_mw)
        if power_mw > self.budget_mw:
            self.throttle = min(self.throttle + 1, self.max_throttle)
            self.over_budget_passes += 1
            self._calm = 0
            return True
        self._calm += 1
        if self.throttle and self._calm >= self.recover_passes:
            self.throttle -= 1
            self._calm = 0
        return False

    @property
    def pressure(self) -> bool:
        """Whether the next memos pass should plan energy-biased."""
        return self.throttle > 0

    def batch_limit(self, max_batch: int) -> int:
        """Admission width under the current throttle (never below 1)."""
        return max(1, max_batch - self.throttle)
