"""Per-slot NVM wear telemetry (paper Sec. 7.1, Table 1 endurance) — the
torch twin of ``repro.nvm.wear``.

  * ``WearState`` — per-*physical*-slot int32 write counters plus the
    logical->physical remap the Start-Gap leveler rotates, as tensors on
    the store's device;
  * ``record_writes`` — the counter update through the ``wear_update``
    kernel (its plain version on CPU tensors);
  * ``NvmWear`` — the host-side tracker owned by ``TierStore``: it maps
    logical slow-pool slots through the remap, buffers write events on
    the host, and flushes them into the device counters with one
    ``wear_update`` kernel launch whenever the telemetry is read.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.wear_update import wear_update


class WearState(NamedTuple):
    wear: torch.Tensor    # int32 [n_slots] writes per physical slot
    remap: torch.Tensor   # int32 [n_slots] logical slot -> physical slot

    @property
    def n_slots(self) -> int:
        return self.wear.shape[0]


def init_wear(n_slots: int, device) -> WearState:
    return WearState(
        wear=torch.zeros(n_slots, dtype=torch.int32, device=device),
        remap=torch.arange(n_slots, dtype=torch.int32, device=device))


def record_writes(state: WearState, phys_slots, amount=None,
                  valid=None) -> WearState:
    """Charge write events onto physical slots (one ``wear_update``
    launch; ``valid`` masks events out).  The counters are updated in
    place; the returned state holds the same tensors."""
    return state._replace(wear=wear_update(state.wear, phys_slots, amount,
                                           valid=valid))


class NvmWear:
    """Host-side wear tracker for one slow pool.

    Keeps the device ``WearState`` plus numpy mirrors of the remap (and
    its inverse) so host read/write paths translate logical slots without
    a device round trip.  Write events accumulate in a host-side pending
    buffer and are flushed into the device counters through the
    ``wear_update`` kernel whenever the telemetry is read — one launch
    per pass instead of one per write.
    """

    def __init__(self, n_slots: int, *, device):
        self.state = init_wear(n_slots, device)
        self._remap = np.arange(n_slots, dtype=np.int64)   # logical -> phys
        self._inv = np.arange(n_slots, dtype=np.int64)     # phys -> logical
        self._pending = np.zeros(n_slots, np.int64)        # unflushed events
        self.writes_total = 0        # app + migration writes (not leveling)
        self.leveling_writes = 0     # extra writes spent rotating the pool

    @property
    def n_slots(self) -> int:
        return self.state.n_slots

    # -- logical -> physical translation --------------------------------------
    def phys(self, slots) -> np.ndarray:
        return self._remap[np.asarray(slots, np.int64)]

    def phys_one(self, slot: int) -> int:
        return int(self._remap[slot])

    # -- counter updates -------------------------------------------------------
    def record_phys(self, phys_slots, *, leveling: bool = False) -> None:
        p = np.asarray(phys_slots, np.int64)
        np.add.at(self._pending, p, 1)
        if leveling:
            self.leveling_writes += int(p.size)
        else:
            self.writes_total += int(p.size)

    def flush(self) -> WearState:
        """Push pending host-side events into the device counters (one
        ``wear_update`` launch, in place) and return the state."""
        ids = np.nonzero(self._pending)[0]
        if ids.size:
            self.state = record_writes(self.state, ids,
                                       amount=self._pending[ids])
            self._pending[ids] = 0
        return self.state

    def adopt_scan_writes(self, new_wear: torch.Tensor, n_app_writes: int,
                          leveling_writes: int = 0) -> None:
        """Adopt counters updated *inside* a fused dual-pool dispatch.

        The pinned-host serving path charges each pinned-tier KV append
        (and the two row rewrites of every in-dispatch Start-Gap advance)
        into this tracker's device counters with ``wear_update``; at the
        dispatch boundary the engine hands the counter tensor back here
        and credits the write totals.  Host-side pending events are a
        separate buffer and are unaffected."""
        self.state = self.state._replace(wear=new_wear)
        self.writes_total += int(n_app_writes)
        self.leveling_writes += int(leveling_writes)

    def adopt_scan_remap(self, new_remap: torch.Tensor) -> None:
        """Adopt the logical->physical remap as rotated by in-dispatch
        Start-Gap advances, so the host mirrors (and every host-side
        read/write path) stay in sync."""
        r = new_remap.cpu().numpy().astype(np.int64)
        self._remap = r
        inv = np.empty_like(r)
        inv[r] = np.arange(r.size, dtype=np.int64)
        self._inv = inv
        self.state = self.state._replace(remap=new_remap.to(torch.int32))

    # -- leveler hook -----------------------------------------------------------
    def swap_phys(self, a: int, b: int) -> None:
        """Swap which logical slots map to physical ``a`` and ``b``."""
        la, lb = int(self._inv[a]), int(self._inv[b])
        self._remap[la], self._remap[lb] = b, a
        self._inv[a], self._inv[b] = lb, la
        self.state.remap[la] = b
        self.state.remap[lb] = a

    # -- telemetry readout -------------------------------------------------------
    def wear_counts(self) -> np.ndarray:
        """int64 [n_slots] per-physical-slot write counts (host copy)."""
        return self.flush().wear.cpu().numpy().astype(np.int64)

    def max_wear(self) -> int:
        return int(self.wear_counts().max(initial=0))

    def mean_wear(self) -> float:
        w = self.wear_counts()
        return float(w.mean()) if w.size else 0.0

    def check(self) -> None:
        """Invariants: remap is a permutation matching its inverse and the
        device copy."""
        self.flush()
        n = self.n_slots
        assert sorted(self._remap.tolist()) == list(range(n)), \
            "remap is not a permutation"
        assert (self._inv[self._remap] == np.arange(n)).all(), \
            "remap inverse out of sync"
        np.testing.assert_array_equal(
            self.state.remap.cpu().numpy().astype(np.int64), self._remap,
            err_msg="device remap out of sync with host mirror")
