"""TierStore — the N-tier hybrid page store (MCHA analogue, Sec. 5.1),
the torch twin of ``repro.core.tiers``.

Logical pages live in one of the pools described by a
:class:`~repro_torch.core.hierarchy.MemoryHierarchy`:

  * **device** tiers — one torch tensor pool each on the store's device
    (tier 0 is HBM and is what compute reads from); bulk moves go
    through the ``page_gather`` / ``page_scatter`` kernels;
  * **host** tiers — numpy pools (the NVM/CXL analogue).  bfloat16
    payloads are stored as their **uint16 bit pattern** (bit-exact round
    trips, half the bytes of float32); float32 payloads natively.

A page table maps logical page -> (tier, slot); per-page version counters
are bumped by every write so the optimistic migration path can detect
pages dirtied mid-copy.  Slot allocation inside every pool goes through
a per-tier color-aware SubBuddy allocator.  Host tiers whose spec sets
``wear_tracked`` charge a per-physical-slot NVM wear counter on every
write through an ``NvmWear`` remap (and rotate under Start-Gap when
``wear_leveling`` is set).

Where the JAX store replaces ``fast_pool`` with each donated dispatch
result, this store keeps **one** tier-0 tensor for its whole life and
every writer updates it in place, so no reference to a stale pool can
survive.  Pinned-host tiers, int8 tiers and page integrity are not
ported; constructing a store that needs them raises.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.page_gather import page_gather, page_scatter

from .allocator import SubBuddyAllocator, SubBuddyConfig
from .hierarchy import MediumSpec, MemoryHierarchy

NO_SLOT = -1
_HOST_DTYPES = {torch.float32: np.float32, torch.bfloat16: np.uint16}


@dataclass
class TierConfig:
    """Two-tier compatibility config; ``TierStore`` converts it to
    ``MemoryHierarchy.two_tier(...)`` + :class:`StoreConfig`."""

    n_pages: int
    fast_slots: int
    slow_slots: int
    page_shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    n_banks: int | None = None
    n_slabs: int | None = None
    track_wear: bool = True
    wear_leveling: bool = True
    gap_write_interval: int | None = None

    def hierarchy(self) -> MemoryHierarchy:
        return MemoryHierarchy.two_tier(
            self.fast_slots, self.slow_slots, track_wear=self.track_wear,
            wear_leveling=self.wear_leveling,
            gap_write_interval=self.gap_write_interval)


@dataclass
class StoreConfig:
    """Generic store config: a hierarchy plus the logical page space."""

    n_pages: int
    page_shape: tuple[int, ...]
    hierarchy: MemoryHierarchy
    dtype: torch.dtype = torch.float32
    # color geometry; None auto-sizes (up to 32 x 16) so every color
    # exists in the smallest pool — explicit values that don't fit are
    # clamped with a warning
    n_banks: int | None = None
    n_slabs: int | None = None

    @property
    def fast_slots(self) -> int:
        return self.hierarchy[0].slots

    @property
    def slow_slots(self) -> int:
        return self.hierarchy[self.hierarchy.deepest].slots


def _shrink_to_fit(n_banks: int, n_slabs: int, slots: int) -> tuple[int, int]:
    """Halve banks, then slabs, until every color exists in a pool of
    ``slots`` pages."""
    while n_banks * n_slabs > max(slots, 1) and n_banks > 1:
        n_banks //= 2
    while n_banks * n_slabs > max(slots, 1) and n_slabs > 1:
        n_slabs //= 2
    return n_banks, n_slabs


def _clamp_geometry(cfg: StoreConfig) -> StoreConfig:
    """Resolve the *monitor* color geometry (SysMon's bank/slab tables):
    auto-sized silently by default, clamped with a warning when an
    explicit request does not fit the smallest pool."""
    explicit = cfg.n_banks is not None or cfg.n_slabs is not None
    want_banks = 32 if cfg.n_banks is None else cfg.n_banks
    want_slabs = 16 if cfg.n_slabs is None else cfg.n_slabs
    min_slots = min(t.slots for t in cfg.hierarchy)
    n_banks, n_slabs = _shrink_to_fit(want_banks, want_slabs, min_slots)
    if explicit and (n_banks, n_slabs) != (want_banks, want_slabs):
        warnings.warn(
            f"TierStore color geometry {want_banks}x{want_slabs} "
            f"(banks x slabs) exceeds the smallest pool "
            f"({min_slots} slots); monitor geometry clamped to "
            f"{n_banks}x{n_slabs} (each tier's allocator keeps its own "
            "geometry sized to its pool)",
            UserWarning, stacklevel=3)
    return replace(cfg, n_banks=n_banks, n_slabs=n_slabs)


def _tier_geometry(want_banks: int | None, want_slabs: int | None,
                   spec: MediumSpec) -> tuple[int, int]:
    """Per-tier allocator geometry sized to the tier's own capacity."""
    return _shrink_to_fit(32 if want_banks is None else want_banks,
                          16 if want_slabs is None else want_slabs,
                          spec.slots)


# =============================================================================
# per-tier pools
# =============================================================================

def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _pad_idx_np(slots) -> np.ndarray:
    """Pad an index vector to the next power-of-two length by repeating
    its last entry, in numpy (the JAX store's bucketing, kept so both
    packages launch the data mover on the same index vectors; a repeated
    index gathers an extra row or rewrites a slot with the same page)."""
    slots = np.asarray(slots, np.int64).reshape(-1)
    pad = _pow2(slots.size) - slots.size
    if pad:
        slots = np.concatenate([slots, np.repeat(slots[-1:], pad)])
    return slots


def _pad_pages(pages, k_padded: int):
    """Pad a page batch to its padded index vector by repeating the last
    page (numpy or torch)."""
    n = pages.shape[0]
    if n == k_padded:
        return pages
    if isinstance(pages, np.ndarray):
        return np.concatenate([pages, np.repeat(pages[-1:], k_padded - n,
                                                axis=0)])
    return torch.cat([pages, pages[-1:].expand(k_padded - n,
                                               *pages.shape[1:])])


def to_host_raw(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy in the host-tier storage format (bfloat16 as
    its uint16 bits).  The tensor must already be on the host and any
    copy into it complete."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def from_host_raw(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Host-tier storage (numpy) as a CPU tensor of ``dtype``, sharing
    memory with ``a``."""
    a = np.ascontiguousarray(a)
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class DevicePool:
    """A page pool tensor [slots, *page_shape] on the store's device."""

    def __init__(self, spec: MediumSpec, page_shape: tuple[int, ...],
                 dtype: torch.dtype, device: torch.device):
        self.spec = spec
        self.dtype = dtype
        self.data = torch.zeros((spec.slots, *page_shape), dtype=dtype,
                                device=device)

    def write_one(self, slot: int, value) -> None:
        self.data[slot] = torch.as_tensor(np.asarray(value, np.float32)).to(
            device=self.data.device, dtype=self.dtype)

    def read_one(self, slot: int) -> np.ndarray:
        return self.data[slot].float().cpu().numpy()

    def gather(self, slots) -> torch.Tensor:
        """Pack discontiguous slots into one contiguous staging tensor
        (``page_gather``).  The result is **pow2-padded** (trailing rows
        repeat the last page); consumers slice to the true count."""
        idx = torch.from_numpy(_pad_idx_np(slots).astype(np.int32))
        return page_gather(self.data, idx.to(self.data.device))

    def scatter(self, slots, pages: torch.Tensor) -> None:
        """pool[slots[i]] = pages[i] in place (``page_scatter``); slots
        not referenced are untouched."""
        idx = _pad_idx_np(slots)
        pages = _pad_pages(pages, idx.size).to(self.dtype).contiguous()
        page_scatter(self.data,
                     torch.from_numpy(idx.astype(np.int32)).to(
                         self.data.device), pages)


class HostPool:
    """A numpy page pool in the host-tier storage format (float32
    natively, bfloat16 as uint16 bits).  ``*_one`` take and return
    float32 values; ``*_raw`` move the storage format untouched (the
    migration engine's bulk path)."""

    def __init__(self, spec: MediumSpec, page_shape: tuple[int, ...],
                 dtype: torch.dtype):
        if dtype not in _HOST_DTYPES:
            raise NotImplementedError(f"host tier dtype {dtype}")
        self.spec = spec
        self.page_shape = page_shape
        self.dtype = dtype
        self.data = np.zeros((spec.slots, *page_shape), _HOST_DTYPES[dtype])

    def write_one(self, phys: int, value: np.ndarray) -> None:
        v = torch.from_numpy(np.asarray(value, np.float32)).to(self.dtype)
        self.data[phys] = to_host_raw(v)

    def read_one(self, phys: int) -> np.ndarray:
        return from_host_raw(self.data[phys], self.dtype).float().numpy()

    def write_raw(self, phys: np.ndarray, raw: np.ndarray) -> None:
        self.data[phys] = raw

    def read_raw(self, phys: np.ndarray) -> np.ndarray:
        return self.data[phys]

    def swap_rows(self, a: int, b: int) -> None:
        """Swap two physical rows in place (Start-Gap leveling advance)."""
        self.data[[a, b]] = self.data[[b, a]]


# =============================================================================
# the store
# =============================================================================

class TierStore:
    def __init__(self, cfg: TierConfig | StoreConfig, *,
                 device: str | torch.device | None = "cuda"):
        if isinstance(cfg, TierConfig):
            cfg = StoreConfig(n_pages=cfg.n_pages, page_shape=cfg.page_shape,
                              hierarchy=cfg.hierarchy(), dtype=cfg.dtype,
                              n_banks=cfg.n_banks, n_slabs=cfg.n_slabs)
        for t in cfg.hierarchy:
            if t.is_pinned or t.quantize_int8:
                raise NotImplementedError(
                    f"tier {t.name!r}: pinned-host and int8 tiers are not "
                    "ported")
        if not cfg.hierarchy[0].is_device:
            raise ValueError("tier 0 must be a device tier")
        self.device = resolve_device(device)
        want_banks, want_slabs = cfg.n_banks, cfg.n_slabs   # pre-clamp ask
        cfg = _clamp_geometry(cfg)
        self.cfg = cfg
        self.hierarchy = cfg.hierarchy
        self.n_tiers = cfg.hierarchy.n_tiers
        self.pools: list[DevicePool | HostPool] = [
            DevicePool(t, cfg.page_shape, cfg.dtype, self.device)
            if t.is_device else HostPool(t, cfg.page_shape, cfg.dtype)
            for t in cfg.hierarchy]
        # pages start (unallocated) in the deepest tier
        self.tier = np.full((cfg.n_pages,), cfg.hierarchy.deepest, np.int8)
        self.slot = np.full((cfg.n_pages,), NO_SLOT, np.int64)
        self.version = np.zeros((cfg.n_pages,), np.int64)
        # incremental dirty set: while an epoch is open, every page whose
        # version/tier/slot changes is recorded
        self._dirty_tracking = False
        self._dirty_pages: set[int] = set()
        self.alloc = [SubBuddyAllocator(SubBuddyConfig(
            t.slots, *_tier_geometry(want_banks, want_slabs, t)))
            for t in cfg.hierarchy]
        # bytes moved per (src, dst) tier pair; _traffic_snap marks the
        # last memos-pass boundary (roll_traffic_window)
        self.traffic = {(i, j): 0 for i in range(self.n_tiers)
                        for j in range(self.n_tiers) if i != j}
        self._traffic_snap = dict(self.traffic)
        self.writes_to = {t: 0 for t in range(self.n_tiers)}
        self.reads_from = {t: 0 for t in range(self.n_tiers)}
        # per-tier NVM wear telemetry + Start-Gap leveling
        from repro_torch.nvm.leveling import StartGapLeveler
        from repro_torch.nvm.wear import NvmWear
        self.wear_by_tier: dict[int, NvmWear] = {}
        self.leveler_by_tier: dict[int, StartGapLeveler] = {}
        for i in cfg.hierarchy.wear_tiers():
            spec = cfg.hierarchy[i]
            self.wear_by_tier[i] = NvmWear(spec.slots, device=self.device)
            if spec.wear_leveling:
                self.leveler_by_tier[i] = StartGapLeveler(
                    self.wear_by_tier[i], spec.gap_write_interval)

    # -- two-tier compat surface ----------------------------------------------
    @property
    def fast_pool(self) -> torch.Tensor:
        """Tier-0 pool tensor (what the serving engine computes on); one
        tensor for the store's lifetime, updated in place."""
        return self.pools[0].data

    @property
    def wear(self):
        """Deepest wear-tracked tier's tracker."""
        wt = self.hierarchy.wear_tiers()
        return self.wear_by_tier[wt[-1]] if wt else None

    @property
    def leveler(self):
        wt = self.hierarchy.wear_tiers()
        return self.leveler_by_tier.get(wt[-1]) if wt else None

    def is_device_tier(self, tier: int) -> bool:
        return self.hierarchy[tier].is_device

    # -- dirty-set epochs -----------------------------------------------------
    def begin_dirty_epoch(self) -> None:
        """Start recording pages whose placement (tier/slot) or contents
        (``write_page`` / ``bump_version``) change."""
        self._dirty_pages.clear()
        self._dirty_tracking = True

    def end_dirty_epoch(self) -> set[int]:
        """Stop recording; return the pages dirtied since the epoch
        opened."""
        self._dirty_tracking = False
        dirty, self._dirty_pages = self._dirty_pages, set()
        return dirty

    def _mark_dirty(self, pages) -> None:
        if self._dirty_tracking:
            self._dirty_pages.update(int(p) for p in np.atleast_1d(pages))

    def bump_version(self, page: int) -> None:
        """Advance a page's version counter (the optimistic-migration
        dirty bit)."""
        self.version[page] += 1
        self._mark_dirty(page)

    # -- page lifecycle -----------------------------------------------------
    @property
    def page_nbytes(self) -> int:
        return (int(np.prod(self.cfg.page_shape))
                * torch.empty((), dtype=self.cfg.dtype).element_size())

    def allocate(self, page: int, tier: int, color: int | None = None,
                 color_mask: int | None = None) -> bool:
        """Bind a logical page to a fresh slot in ``tier``."""
        assert self.slot[page] == NO_SLOT, f"page {page} already allocated"
        s = self.alloc[tier].alloc(0, color, color_mask)
        if s is None:
            return False
        self.tier[page] = tier
        self.slot[page] = s
        self._mark_dirty(page)
        return True

    def release(self, page: int) -> None:
        s = int(self.slot[page])
        if s != NO_SLOT:
            self.alloc[int(self.tier[page])].free(s, 0)
            self.slot[page] = NO_SLOT
            self._mark_dirty(page)

    # -- single-page data access ------------------------------------------------
    def write_page(self, page: int, value) -> None:
        t, s = int(self.tier[page]), int(self.slot[page])
        assert s != NO_SLOT
        if self.is_device_tier(t):
            self.pools[t].write_one(s, value)
        else:
            self._host_write(t, s, np.asarray(value, np.float32))
        self.bump_version(page)
        self.writes_to[t] += 1

    def read_page(self, page: int) -> np.ndarray:
        t, s = int(self.tier[page]), int(self.slot[page])
        assert s != NO_SLOT
        self.reads_from[t] += 1
        if self.is_device_tier(t):
            return self.pools[t].read_one(s)
        return self.pools[t].read_one(self._phys_one(t, s))

    # -- host-tier access (wear remap + accounting) ----------------------------
    def _phys(self, tier: int, slots: np.ndarray) -> np.ndarray:
        """Logical host-pool slots -> physical rows (wear-leveling remap)."""
        w = self.wear_by_tier.get(tier)
        return slots if w is None else w.phys(slots)

    def _phys_one(self, tier: int, slot: int) -> int:
        w = self.wear_by_tier.get(tier)
        return slot if w is None else w.phys_one(slot)

    def _account_host_writes(self, tier: int, phys: np.ndarray) -> None:
        """Charge wear counters and drive the tier's Start-Gap leveler
        after data has landed on the given physical rows."""
        w = self.wear_by_tier.get(tier)
        if w is None:
            return
        w.record_phys(phys)
        lv = self.leveler_by_tier.get(tier)
        if lv is not None:
            lv.note_writes(self.pools[tier], np.asarray(phys).size)

    def _host_write(self, tier: int, slot: int, value: np.ndarray) -> None:
        p = self._phys_one(tier, slot)
        self.pools[tier].write_one(p, value)
        self._account_host_writes(tier, np.asarray([p]))

    # -- batched data access (the migration engine's bulk primitives) ----------
    def gather_device(self, tier: int, slots) -> torch.Tensor:
        """Pack a device tier's slots into one pow2-padded staging tensor."""
        return self.pools[tier].gather(slots)

    def scatter_device(self, tier: int, slots, pages: torch.Tensor) -> None:
        """pool[slots[i]] = pages[i] on a device tier, in place."""
        self.pools[tier].scatter(slots, pages)

    def host_read_raw(self, tier: int, slots: np.ndarray) -> np.ndarray:
        """[k, *page_shape] of a host tier's slots in storage format."""
        return self.pools[tier].read_raw(
            self._phys(tier, np.asarray(slots, np.int64)))

    def host_write_raw(self, tier: int, slots: np.ndarray,
                       raw: np.ndarray) -> None:
        """pool[slots[i]] = raw[i] on a host tier (storage format),
        charging wear where tracked."""
        phys = self._phys(tier, np.asarray(slots, np.int64))
        self.pools[tier].write_raw(phys, raw)
        self._account_host_writes(tier, phys)

    def charge_fast_accesses(self, page_writes: np.ndarray,
                             n_reads: int) -> None:
        """Apply one decode dispatch's tier-0 access accounting in bulk:
        per-page write counts bump the version counters (the optimistic
        migration dirty bit) and the tier write counter; ``n_reads`` is
        the dispatch's page-read total.  In-place appends do not dirty an
        open epoch."""
        page_writes = np.asarray(page_writes, np.int64)
        self.version += page_writes
        self.writes_to[0] += int(page_writes.sum())
        self.reads_from[0] += int(n_reads)

    # -- bandwidth headroom (spill / cascade targeting) ------------------------
    def roll_traffic_window(self) -> None:
        """Mark a pass boundary for the per-tier inflow window."""
        self._traffic_snap = dict(self.traffic)

    def tier_inflow_bytes(self, tier: int) -> int:
        """Bytes that landed in ``tier`` since the last window roll."""
        return sum(self.traffic[(s, tier)] - self._traffic_snap[(s, tier)]
                   for s in range(self.n_tiers) if s != tier)

    def backing_tier_order(self, start: int = 1) -> list[int]:
        """Backing tiers ``start..deepest`` by bandwidth headroom over the
        current traffic window (ties toward the faster tier, i.e. plain
        tier order for unmodeled bandwidths)."""
        def utilization(t: int) -> float:
            bw = self.hierarchy[t].bandwidth_gbps
            if bw <= 0:
                return 0.0
            return self.tier_inflow_bytes(t) / (bw * 2**30)
        return sorted(range(start, self.n_tiers),
                      key=lambda t: (utilization(t), t))

    def commit_moves(self, pages: np.ndarray, dst_tier: int,
                     new_slots: np.ndarray) -> None:
        """Flip the page table for an executed bulk move: free the old
        slots, bind the new ones, account per-pair traffic."""
        pages = np.asarray(pages, np.int64)
        new_slots = np.asarray(new_slots, np.int64)
        if pages.size == 0:
            return
        src_tiers = self.tier[pages].copy()
        assert (src_tiers != dst_tier).all(), \
            "commit_moves: page already in the destination tier"
        for p, s in zip(pages, self.slot[pages]):
            self.alloc[int(self.tier[p])].free(int(s), 0)
        self.tier[pages] = dst_tier
        self.slot[pages] = new_slots
        self._mark_dirty(pages)
        for t in np.unique(src_tiers):
            k = int((src_tiers == t).sum())
            self.traffic[(int(t), dst_tier)] += self.page_nbytes * k

    def tier_used(self) -> list[int]:
        """Live page count per tier."""
        live = self.slot != NO_SLOT
        return [int(np.sum(self.tier[live] == t))
                for t in range(self.n_tiers)]

    def occupancy(self) -> dict:
        used = self.tier_used()
        out = {
            "fast_used": used[0], "fast_total": self.hierarchy[0].slots,
            "slow_used": used[-1],
            "slow_total": self.hierarchy[self.hierarchy.deepest].slots,
        }
        for i, spec in enumerate(self.hierarchy):
            out[f"t{i}_{spec.name.lower()}_used"] = used[i]
            out[f"t{i}_{spec.name.lower()}_total"] = spec.slots
        return out

    def publish_metrics(self, reg) -> None:
        """Publish per-tier occupancy / IO counters and per-(src, dst)
        migration traffic into an ``obs.MetricsRegistry``."""
        used = self.tier_used()
        for i, spec in enumerate(self.hierarchy):
            name = spec.name.lower()
            reg.gauge(f"store.t{i}_used",
                      f"live pages in tier {i} ({name})").set(used[i])
            reg.gauge(f"store.t{i}_slots",
                      f"capacity of tier {i} ({name})").set(spec.slots)
            reg.gauge(f"store.t{i}_reads",
                      f"page reads served from tier {i}").set(
                          self.reads_from[i])
            reg.gauge(f"store.t{i}_writes",
                      f"page writes landed in tier {i}").set(
                          self.writes_to[i])
        for (s, d), b in self.traffic.items():
            if b:
                reg.gauge(f"store.migration_bytes_t{s}_t{d}",
                          f"bytes migrated tier {s} -> tier {d}").set(b)
