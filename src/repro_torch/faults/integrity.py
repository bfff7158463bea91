"""Per-page checksums for the slow tiers — the detection half of
recovery (the torch twin of ``repro.faults.integrity``).

Checksums (definition in ``repro_torch.kernels.page_checksum``) are
keyed by **(tier, logical slot)**: logical slots are stable under the
wear-leveling remap, so a Start-Gap advance that physically relocates a
row never invalidates its checksum.  Device tier 0 is trusted (HBM is
not the asymmetric media the fault model targets); every host and
pinned tier is covered.  A numpy host pool is summed on the host
(``checksum_np``); the pinned-host pool is summed in place by kernel K5
over its mapped device address, in stream order after every write the
card has queued to it.

Lifecycle: recorded on every write that lands in a covered tier,
dropped when the slot is freed, verified on promotion pre-flight, on
the serving engine's pre-dispatch sweep, and by the budgeted
round-robin :meth:`scrub` at memos-pass boundaries.  A mismatch means
the stored bits changed outside any write path — the slot is
quarantined and the owning sequence fails cleanly.
"""
from __future__ import annotations

import numpy as np
import torch


class PageIntegrity:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.sums: dict[tuple[int, int], int] = {}   # (tier, slot) -> uint32
        self._scrub_cursor = 0

    def covers(self, store, tier: int) -> bool:
        return not store.is_device_tier(tier)

    # -- checksum computation over the *stored* bits ---------------------------
    def slot_checksums(self, store, tier: int, slots) -> np.ndarray:
        # kernel import is deferred: repro_torch.kernels sits beside core,
        # which imports this module
        from repro_torch.kernels.page_checksum import (checksum_np,
                                                       page_checksum)
        slots = np.asarray(slots, np.int64).reshape(-1)
        phys = store._phys(tier, slots)
        pool = store.pools[tier]
        if isinstance(pool.data, np.ndarray):
            return checksum_np(pool.data[phys])
        # pinned pool: one K5 launch over the physical rows, on the store's
        # device (the card reads the pool in place)
        idx = torch.from_numpy(phys.astype(np.int32)).to(store.device)
        return page_checksum(pool.data, idx).cpu().numpy()

    # -- lifecycle -------------------------------------------------------------
    def record(self, store, tier: int, slots) -> None:
        if not self.enabled or not self.covers(store, tier):
            return
        slots = np.asarray(slots, np.int64).reshape(-1)
        if slots.size == 0:
            return
        sums = self.slot_checksums(store, tier, slots)
        for s, c in zip(slots, sums):
            self.sums[(tier, int(s))] = int(c)

    def drop(self, tier: int, slots) -> None:
        if not self.enabled:
            return
        for s in np.atleast_1d(np.asarray(slots, np.int64)):
            self.sums.pop((tier, int(s)), None)

    def verify(self, store, tier: int, slots) -> list[int]:
        """The subset of ``slots`` whose stored bits no longer match their
        recorded checksum (unrecorded slots pass)."""
        if not self.enabled or not self.covers(store, tier):
            return []
        slots = np.asarray(slots, np.int64).reshape(-1)
        known = np.asarray([(tier, int(s)) in self.sums for s in slots],
                           bool)
        if not known.any():
            return []
        slots = slots[known]
        sums = self.slot_checksums(store, tier, slots)
        return [int(s) for s, c in zip(slots, sums)
                if self.sums[(tier, int(s))] != int(c)]

    def scrub(self, store, budget: int) -> list[tuple[int, int]]:
        """Verify up to ``budget`` recorded slots, round-robin across
        passes; returns the (tier, slot) pairs that failed."""
        if not self.enabled or not self.sums or budget <= 0:
            return []
        keys = sorted(self.sums.keys())
        start = self._scrub_cursor % len(keys)
        batch = [keys[(start + i) % len(keys)]
                 for i in range(min(budget, len(keys)))]
        self._scrub_cursor = (start + len(batch)) % max(len(keys), 1)
        bad: list[tuple[int, int]] = []
        by_tier: dict[int, list[int]] = {}
        for t, s in batch:
            by_tier.setdefault(t, []).append(s)
        for t, slots in by_tier.items():
            bad.extend((t, s) for s in self.verify(store, t, slots))
        return bad
