"""Structured fault exceptions, split by who recovers (a copy of
``repro.faults.errors``):

* :class:`CapacityError` / :class:`PageCorruptionError` fail one
  request cleanly (``Request.error``) while the engine keeps serving;
* :class:`TransientMigrationFault` / :class:`InjectedPlanFault` are
  injected beneath the migration engine's retry loop and the memos
  plan watchdog, and should normally never escape to a caller.
"""
from __future__ import annotations


class FaultError(RuntimeError):
    """Base class for every injected or capacity fault."""


class CapacityError(FaultError):
    """All pools exhausted and preemption cannot free a page.

    Raised per-request (attached to ``Request.error``), not per-engine:
    the blocked sequence fails cleanly, everything else keeps decoding.
    """

    def __init__(self, msg: str, *, rid: int | None = None,
                 occupancy: dict | None = None):
        super().__init__(msg)
        self.rid = rid
        self.occupancy = occupancy or {}


class PageCorruptionError(FaultError):
    """A page's stored bits no longer match its recorded checksum and
    the slot was quarantined — the owning sequence fails cleanly."""

    def __init__(self, msg: str, *, rid: int | None = None,
                 pages: list[int] | None = None):
        super().__init__(msg)
        self.rid = rid
        self.pages = list(pages or [])


class TransientMigrationFault(FaultError):
    """Injected failure of one per-(src,dst) bulk move; retried with
    backoff by the migration engine, surfaced only past the cap."""


class InjectedPlanFault(FaultError):
    """Injected exception inside the asynchronous plan worker; absorbed
    by the MemosManager watchdog (sync fallback + ladder demotion)."""
