"""Fault injection and graceful degradation — the torch twin of
``repro.faults``.

``faults.configure(FaultConfig(...))`` arms the global seeded injector;
disarmed (the default, and after ``faults.reset()``) every injection
site is a dead branch.  ``injector.py`` holds the media, plan-worker,
migration and allocation sites, ``integrity.py`` the checksum / scrub /
quarantine detection layer on kernel K5, ``degradation.py`` the
overlap -> sync -> memos-off ladder, and ``errors.py`` who recovers
from what.
"""
from .degradation import (RUNG_OFF, RUNG_OVERLAP, RUNG_SYNC,
                          DegradationLadder)
from .errors import (CapacityError, FaultError, InjectedPlanFault,
                     PageCorruptionError, TransientMigrationFault)
from .injector import (FaultConfig, FaultInjector, configure, get_injector,
                       note_recovered, reset)
from .integrity import PageIntegrity

__all__ = [
    "FaultConfig", "FaultInjector", "configure", "get_injector", "reset",
    "note_recovered", "PageIntegrity", "DegradationLadder", "RUNG_OFF",
    "RUNG_SYNC", "RUNG_OVERLAP", "FaultError", "CapacityError",
    "PageCorruptionError", "InjectedPlanFault", "TransientMigrationFault",
]
