"""Start-Gap-style wear leveling over the slow pool (paper Sec. 7.1).

The paper assumes Start-Gap leveling at 95% of ideal cell lifetime for
its NVM projections; this module makes that mechanism real for the port:
a gap pointer sweeps the physical slot space, and every ``gap_write_interval``
slow-tier writes it advances one position by swapping two adjacent
physical rows and updating the logical->physical remap in ``NvmWear``.
After a full sweep every row has shifted by one — a rotation, so a
write-hot *logical* slot spreads its wear across every *physical* slot
over time while the page table, allocator, and migration engines keep
using stable logical slot ids (they never notice the rotation).

The classic Start-Gap keeps one spare row and moves the gap with a single
copy; we have no spare row in the pool, so an advance is an adjacent-row
swap (two writes instead of one — charged to the wear counters as
leveling overhead).  The default advance interval derives from the cost
model's pinned 95%-of-ideal leveling efficiency.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.costmodel import startgap_interval

from .wear import NvmWear


@dataclass
class LevelingStats:
    advances: int = 0       # gap moves executed
    rotations: int = 0      # completed full sweeps of the pool
    gap: int = 0            # current gap position (physical slot)


class StartGapLeveler:
    """Rotates the physical slow pool underneath the logical slot space.

    ``note_writes(pool, n)`` is called by the TierStore after every
    slow-tier write; once the pending count crosses the interval the gap
    advances.  ``advance(pool)`` swaps physical rows ``gap`` and
    ``gap+1`` (data, remap, wear charge).
    """

    def __init__(self, wear: NvmWear, gap_write_interval: int | None = None):
        self.wear = wear
        self.interval = (startgap_interval() if gap_write_interval is None
                         else max(1, int(gap_write_interval)))
        self.stats = LevelingStats()
        self._pending = 0

    def note_writes(self, pool, n: int) -> int:
        """Account ``n`` demand writes; advance the gap as many steps as
        the interval allows.  Returns the number of advances performed."""
        if self.wear.n_slots < 2:
            return 0
        self._pending += int(n)
        done = 0
        while self._pending >= self.interval:
            self._pending -= self.interval
            self.advance(pool)
            done += 1
        return done

    def advance(self, pool) -> None:
        """One gap move: swap physical rows (gap, gap+1) of the slow pool
        through ``pool.swap_rows``."""
        a = self.stats.gap
        b = a + 1
        pool.swap_rows(a, b)
        self.wear.swap_phys(a, b)
        # the swap physically rewrites both rows
        self.wear.record_phys([a, b], leveling=True)
        self.stats.advances += 1
        self.stats.gap = b
        if self.stats.gap >= self.wear.n_slots - 1:
            self.stats.gap = 0
            self.stats.rotations += 1
