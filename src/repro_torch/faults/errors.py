"""Structured fault exceptions (the part of ``repro.faults.errors`` the
serving path raises)."""
from __future__ import annotations


class FaultError(RuntimeError):
    """Base class for every capacity fault."""


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
