"""Three-rung degradation ladder + circuit breaker (the torch twin of
``repro.faults.degradation``).

    rung 2  OVERLAP    asynchronous plan on the worker thread
    rung 1  SYNC       synchronous memos pass (no worker exposure)
    rung 0  MEMOS_OFF  no planning/migration at all — serve-only

A failed pass (a plan-watchdog fallback, a migration group that faulted
past its retry budget, or a page that failed its promotion pre-flight)
demotes one rung and resets the health streak; after
``recovery_passes`` consecutive healthy passes the breaker re-promotes
one rung, so a storm degrades boundedly and the pipeline climbs back to
full overlap once it calms down.  The current rung is published as the
``faults.ladder_rung`` gauge.
"""
from __future__ import annotations

RUNG_OFF = 0
RUNG_SYNC = 1
RUNG_OVERLAP = 2

_RUNG_NAMES = {RUNG_OFF: "memos-off", RUNG_SYNC: "sync",
               RUNG_OVERLAP: "overlap"}


class DegradationLadder:
    def __init__(self, top: int = RUNG_OVERLAP, recovery_passes: int = 3):
        if top not in _RUNG_NAMES:
            raise ValueError(f"top rung {top} is not one of "
                             f"{sorted(_RUNG_NAMES)}")
        self.top = top
        self.rung = top
        self.recovery_passes = recovery_passes
        self._healthy = 0
        self.demotions = 0
        self.promotions = 0
        self.failures: list[str] = []      # demotion reasons, in order

    @property
    def rung_name(self) -> str:
        return _RUNG_NAMES[self.rung]

    def record_failure(self, reason: str = "") -> bool:
        """One failed pass: demote a rung (if any left).  Returns True
        when a demotion happened."""
        self._healthy = 0
        self.failures.append(reason)
        if self.rung > RUNG_OFF:
            self.rung -= 1
            self.demotions += 1
            self._publish()
            return True
        return False

    def record_healthy(self) -> bool:
        """One clean pass: after ``recovery_passes`` in a row, re-promote
        a rung.  Returns True when a promotion happened."""
        self._healthy += 1
        if self.rung < self.top and self._healthy >= self.recovery_passes:
            self.rung += 1
            self.promotions += 1
            self._healthy = 0
            self._publish()
            from .injector import note_recovered
            note_recovered("promotion")
            return True
        return False

    def _publish(self) -> None:
        from repro_torch import obs
        obs.get_registry().gauge(
            "faults.ladder_rung",
            "degradation rung: 2=overlap 1=sync 0=memos-off",
        ).set(self.rung)
