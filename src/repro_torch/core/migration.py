"""Migration engine (paper Sec. 6.3, Fig. 10 step 4): plan/execute split,
generic over the tiers of a :class:`~repro_torch.core.hierarchy.MemoryHierarchy`
— the torch twin of ``repro.core.migration``'s synchronous path.

  * **plan** (host) — reserve each page's destination slot per
    Algorithm 2 (coldest bank, then coldest non-reserved slab;
    reserved-slab routing for Thrashing/Rarely-touched pages) in the
    destination tier's sub-buddy allocator.  The output is a
    ``MigrationPlan``: parallel arrays of (page, src tier, src slot,
    dst slot).
  * **execute** (device) — bulk data movement per (source, destination)
    residency pair:

      - device -> device: ``page_gather`` out of the source pool,
        ``page_scatter`` into the destination pool;
      - device -> host: ``page_gather`` into contiguous device staging,
        then chunked non-blocking copies into pinned host buffers; the
        host reads them only after the stream has synchronised;
      - host -> device: chunked uploads through pinned buffers, then an
        in-place ``page_scatter``;
      - host -> host: one vectorized numpy copy.

Host tiers move pages in their storage format (bfloat16 as uint16 bits),
so a round trip through the slow tier is bit-exact.

Two paths, as in the paper: ``locked`` (synchronous, commit
unconditionally; promotions toward tier 0) and ``optimistic``
(snapshot version counters, copy without blocking writers, commit only
pages whose version did not advance, retry dirtied pages; bulk
demotions).  The allocator call order is the JAX engine's, so both
packages land every page in the same slot.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterable

import numpy as np
import torch

from repro_torch import obs

from . import placement
from .tiers import (NO_SLOT, TierStore, _pad_idx_np, _pad_pages, _pow2,
                    from_host_raw, to_host_raw)


@dataclass
class MigrationStats:
    migrated: int = 0
    dirty_discards: int = 0
    retries: int = 0
    retries_exhausted: int = 0    # pages still dirty at the retry cap
    failed: int = 0               # pages dropped by exhausted move faults
    bytes_moved: int = 0
    to_fast: int = 0              # moves into tier 0
    to_slow: int = 0              # moves into any slower tier
    by_pair: dict = field(default_factory=dict)   # (src, dst) -> pages moved

    def note_move(self, src_tier: int, dst_tier: int, n: int = 1) -> None:
        if n:
            key = (int(src_tier), int(dst_tier))
            self.by_pair[key] = self.by_pair.get(key, 0) + n

    def merge(self, other: "MigrationStats") -> None:
        self.migrated += other.migrated
        self.dirty_discards += other.dirty_discards
        self.retries += other.retries
        self.retries_exhausted += other.retries_exhausted
        self.failed += other.failed
        self.bytes_moved += other.bytes_moved
        self.to_fast += other.to_fast
        self.to_slow += other.to_slow
        for k, v in other.by_pair.items():
            self.by_pair[k] = self.by_pair.get(k, 0) + v

    def to_dict(self) -> dict:
        """JSON-safe form: the (src, dst) tuple keys of ``by_pair``
        serialize as ``"src->dst"`` strings."""
        return {
            "migrated": self.migrated,
            "dirty_discards": self.dirty_discards,
            "retries": self.retries,
            "retries_exhausted": self.retries_exhausted,
            "failed": self.failed,
            "bytes_moved": self.bytes_moved,
            "to_fast": self.to_fast,
            "to_slow": self.to_slow,
            "by_pair": {f"{s}->{d}": n
                        for (s, d), n in sorted(self.by_pair.items())},
        }


# =============================================================================
# slot targeting (Algorithm 2) — shared by both engines
# =============================================================================

def target_color(store: TierStore, dst_tier: int,
                 bank_freq: np.ndarray | None,
                 slab_freq: np.ndarray | None,
                 reuse_class: int | None = None) -> tuple[int | None, int | None]:
    """color = bank*n_slabs + slab, per Algorithm 2 + reserved-slab rules."""
    cfg = store.alloc[dst_tier].cfg
    if bank_freq is None or slab_freq is None:
        return None, None
    forced_slab = (placement.slab_for_reuse_class(reuse_class)
                   if reuse_class is not None else None)

    # fold the monitor's bank/slab frequency space onto the allocator's
    # (the monitor tracks logical banks = device shards, which may be a
    # different cardinality from the slot pool's color geometry)
    def fold(freq: np.ndarray, n: int) -> np.ndarray:
        out = np.zeros(n, dtype=np.float64)
        for i, v in enumerate(np.asarray(freq)):
            out[i % n] += v
        return out

    bfreq = fold(bank_freq, cfg.n_banks)
    sfreq = fold(slab_freq, cfg.n_slabs)

    def rows_free(bank: int, slab: int) -> bool:
        # optimistic probe; the allocator falls back to any color when
        # the exact color is exhausted (see TierStore.move_page)
        return True

    if forced_slab is not None:
        bank = int(np.argmin(bfreq))
        slab = forced_slab % cfg.n_slabs
        return bank * cfg.n_slabs + slab, cfg.n_colors - 1
    reserved = tuple(r for r in (placement.RESERVED_THRASH_SLAB,
                                 placement.RESERVED_RARE_SLAB)
                     if r < cfg.n_slabs) if cfg.n_slabs > 2 else ()
    got = placement.coldest_bank_and_slab(bfreq, sfreq, rows_free,
                                          reserved=reserved)
    if got is None:
        return None, None
    bank, slab = got
    return bank * cfg.n_slabs + slab, cfg.n_colors - 1


def _alloc_target_slot_rec(store, dst_tier: int,
                           bank_freq: np.ndarray | None,
                           slab_freq: np.ndarray | None,
                           reuse_class: int | None
                           ) -> tuple[int | None, int, int]:
    """Reserve one destination slot per Algorithm 2, falling back to any
    color when the targeted slab walk is exhausted (capacity is the real
    bound, not color).  Returns (slot, color, mask) where color/mask
    record the allocator call that actually produced the slot (-1 = any
    color), as the JAX plan records them for its asynchronous commit."""
    color, mask = target_color(store, dst_tier, bank_freq, slab_freq,
                               reuse_class)
    slot = store.alloc[dst_tier].alloc(0, color, mask)
    if slot is not None:
        return slot, (-1 if color is None else int(color)), \
            (-1 if mask is None else int(mask))
    if color is not None:
        slot = store.alloc[dst_tier].alloc(0, None)
    return slot, -1, -1


def _alloc_target_slot(store, dst_tier: int,
                       bank_freq: np.ndarray | None,
                       slab_freq: np.ndarray | None,
                       reuse_class: int | None) -> int | None:
    return _alloc_target_slot_rec(store, dst_tier, bank_freq, slab_freq,
                                  reuse_class)[0]


# =============================================================================
# plans
# =============================================================================

@dataclass
class MigrationPlan:
    """A reserved, executable bulk move into one destination tier.

    ``pages[i]`` moves from ``src_tiers[i]`` / ``src_slots[i]`` ->
    ``dst_slots[i]`` (reserved in ``dst_tier``).  Source tiers may be
    mixed within one plan.  ``trivial`` counts pages that were requested
    but already sit in ``dst_tier`` (the locked path reports them as
    migrated without moving data, like the reference).

    ``colors``/``masks`` record the Algorithm-2 allocator call that
    reserved each slot (-1 = any color), as the JAX plan does.
    ``reads_by_tier`` carries the staging read charge for plans whose
    copy stages pages that a later check may drop.
    """
    dst_tier: int
    pages: np.ndarray       # int64 [k]
    src_tiers: np.ndarray   # int8  [k]
    src_slots: np.ndarray   # int64 [k]
    dst_slots: np.ndarray   # int64 [k]
    trivial: int = 0
    colors: np.ndarray | None = None   # int64 [k], -1 = any
    masks: np.ndarray | None = None    # int64 [k], -1 = full mask
    reads_by_tier: dict = field(default_factory=dict)

    def __len__(self) -> int:
        return int(self.pages.size)


def plan_locked(store: TierStore, pages: Iterable[int], dst_tier: int,
                bank_freq: np.ndarray | None = None,
                slab_freq: np.ndarray | None = None,
                reuse_class: np.ndarray | None = None) -> MigrationPlan:
    """Phase 1 for the locked path: reserve destination slots for every
    movable page, in hotness-list order (allocator call sequence identical
    to the reference engine's, so both engines land pages in the same
    slots)."""
    bank_freq = None if bank_freq is None else np.array(bank_freq)
    mv_pages: list[int] = []
    src_tiers: list[int] = []
    src_slots: list[int] = []
    dst_slots: list[int] = []
    colors: list[int] = []
    masks: list[int] = []
    planned: dict[int, int] = {}            # page -> reserved dst slot
    trivial = 0

    def account(slot: int) -> None:
        # account the move so subsequent picks spread across banks
        if bank_freq is not None:
            cfg = store.alloc[dst_tier].cfg
            bank_freq[cfg.bank_of(slot) % len(bank_freq)] += 1

    for p in pages:
        p = int(p)
        cur_slot = planned.get(p, int(store.slot[p]))
        if int(store.tier[p]) == dst_tier or p in planned:
            # already there (or already planned this batch): the reference
            # reports these as migrated without moving data
            trivial += 1
            account(cur_slot)
            continue
        if cur_slot == NO_SLOT:
            continue                        # released page: nothing to move
        rc = None if reuse_class is None else int(reuse_class[p])
        new_slot, color, mask = _alloc_target_slot_rec(
            store, dst_tier, bank_freq, slab_freq, rc)
        if new_slot is None:
            continue
        mv_pages.append(p)
        src_tiers.append(int(store.tier[p]))
        src_slots.append(cur_slot)
        dst_slots.append(new_slot)
        colors.append(color)
        masks.append(mask)
        planned[p] = new_slot
        account(new_slot)
    return MigrationPlan(
        dst_tier=dst_tier,
        pages=np.asarray(mv_pages, np.int64),
        src_tiers=np.asarray(src_tiers, np.int8),
        src_slots=np.asarray(src_slots, np.int64),
        dst_slots=np.asarray(dst_slots, np.int64),
        trivial=trivial,
        colors=np.asarray(colors, np.int64),
        masks=np.asarray(masks, np.int64),
    )


def plan_optimistic(store, pages: Iterable[int], dst_tier: int,
                    bank_freq: np.ndarray | None = None,
                    slab_freq: np.ndarray | None = None,
                    reuse_class: np.ndarray | None = None) -> MigrationPlan:
    """Phase 1 for the optimistic path: the reservation sequence of one
    clean ``migrate_optimistic`` attempt (dedupe, skip already-there /
    released pages, one Algorithm-2 allocator call per page in list
    order, *no* bank-frequency accounting between picks) without touching
    any data."""
    pending = [int(p) for p in dict.fromkeys(int(p) for p in pages)
               if int(store.tier[p]) != dst_tier
               and int(store.slot[p]) != NO_SLOT]
    bank_freq = None if bank_freq is None else np.array(bank_freq)
    mv_pages: list[int] = []
    src_tiers: list[int] = []
    src_slots: list[int] = []
    dst_slots: list[int] = []
    colors: list[int] = []
    masks: list[int] = []
    reads_by_tier: dict[int, int] = {}
    for p in pending:
        # the unlocked copy stages every pending page before the dirty
        # check — mirror its read charge even for pages dropped below
        t = int(store.tier[p])
        reads_by_tier[t] = reads_by_tier.get(t, 0) + 1
    for p in pending:
        rc = None if reuse_class is None else int(reuse_class[p])
        new_slot, color, mask = _alloc_target_slot_rec(
            store, dst_tier, bank_freq, slab_freq, rc)
        if new_slot is None:
            continue          # capacity exhausted: drop, like the engines
        mv_pages.append(p)
        src_tiers.append(int(store.tier[p]))
        src_slots.append(int(store.slot[p]))
        dst_slots.append(new_slot)
        colors.append(color)
        masks.append(mask)
    return MigrationPlan(
        dst_tier=dst_tier,
        pages=np.asarray(mv_pages, np.int64),
        src_tiers=np.asarray(src_tiers, np.int8),
        src_slots=np.asarray(src_slots, np.int64),
        dst_slots=np.asarray(dst_slots, np.int64),
        trivial=0,
        colors=np.asarray(colors, np.int64),
        masks=np.asarray(masks, np.int64),
        reads_by_tier=reads_by_tier,
    )


def _group_decision(store, decision: placement.PlacementDecision
                    ) -> tuple[dict, dict]:
    """(promotions, demotions) per destination tier, in hotness-list
    order: the JAX engine's grouping, so both packages make the same
    allocator calls in the same order."""
    cur = store.tier
    tgt = decision.target_tier
    promos = {t: [] for t in range(store.n_tiers)}
    demos = {t: [] for t in range(store.n_tiers)}
    for p in decision.hotness_list:
        src, dst = int(cur[p]), int(tgt[p])
        if dst == src:
            continue
        (promos if dst < src else demos)[dst].append(int(p))
    return promos, demos


def execute_decision(engine, decision: placement.PlacementDecision,
                     bank_freq: np.ndarray | None = None,
                     slab_freq: np.ndarray | None = None,
                     reuse_class: np.ndarray | None = None) -> MigrationStats:
    """Direction routing (Sec. 6.3 observed
    asymmetry): promotions — moves toward a faster tier, hot/WD pages —
    take the locked path (small, must be consistent *now*); demotions —
    bulk cold/RD moves toward slower tiers — take the optimistic DMA
    path.  Pages are grouped per destination tier (shallowest first, in
    hotness-list order within each group), the JAX engine's allocator
    call order."""
    st = MigrationStats()
    n_tiers = engine.store.n_tiers
    promos, demos = _group_decision(engine.store, decision)
    for dst in range(n_tiers):
        if promos[dst]:
            st.merge(engine.migrate_locked(promos[dst], dst, bank_freq,
                                           slab_freq, reuse_class))
    for dst in range(n_tiers):
        if demos[dst]:
            st.merge(engine.migrate_optimistic(demos[dst], dst, bank_freq,
                                               slab_freq, reuse_class))
    return st


def _classify(st: MigrationStats, dst_tier: int, n: int) -> None:
    """Two-tier compat stat buckets: moves into tier 0 count as to_fast,
    everything else as to_slow."""
    if dst_tier == 0:
        st.to_fast += n
    else:
        st.to_slow += n


def _note_retries_exhausted(st: MigrationStats, n: int) -> None:
    """Pages still dirty when the optimistic retry cap hit: dropped this
    pass (a later pass re-plans them) rather than livelocking the loop."""
    if n:
        st.retries_exhausted += n
        obs.get_registry().counter(
            "migrate.retries_exhausted",
            "pages dropped at the optimistic dirty-retry cap").inc(n)




# =============================================================================
# batched device-resident engine
# =============================================================================

class BatchedMigrationEngine:
    """Executes migration plans as bulk moves (see module docstring).
    ``chunk_pages`` bounds the staging working set of host<->device
    moves: every chunk's gather and copy is enqueued before the host
    waits once for all of them."""

    def __init__(self, store: TierStore, *, max_retries: int = 3,
                 chunk_pages: int = 64, retry_backoff_s: float = 1e-3):
        self.store = store
        self.max_retries = max_retries
        self.chunk_pages = max(1, int(chunk_pages))
        self.retry_backoff_s = retry_backoff_s
        self.stats = MigrationStats()

    # -- bulk staging ----------------------------------------------------------
    def _stage_device_to_host(self, src_tier: int,
                              slots: np.ndarray) -> np.ndarray:
        """Gather a device tier's slots into device staging
        (``page_gather``) chunk by chunk, copy each chunk into a pinned
        host buffer without blocking, then synchronise the stream once
        before numpy reads any of them.  Returns the pages in host
        storage format."""
        store = self.store
        slots = np.asarray(slots, np.int64)
        on_card = store.device.type == "cuda"
        bufs = []
        for i in range(0, slots.size, self.chunk_pages):
            chunk = slots[i:i + self.chunk_pages]
            g = store.gather_device(src_tier, chunk)
            host = torch.empty(g.shape, dtype=g.dtype, pin_memory=on_card)
            host.copy_(g, non_blocking=on_card)
            bufs.append((host, chunk.size))
        if on_card:
            # the copies are asynchronous: numpy must not read the pinned
            # buffers before they have landed
            torch.cuda.current_stream(store.device).synchronize()
        # gathers come back pow2-padded; slice to true counts
        return np.concatenate([to_host_raw(h)[:n] for h, n in bufs])

    def _stage_host_to_device(self, dst_tier: int, dst_slots: np.ndarray,
                              raw: np.ndarray) -> None:
        """Upload host pages (storage format) chunk by chunk through
        pinned buffers and scatter each chunk into its planned device
        slots (``page_scatter``, in place).  Chunks are pow2-padded on
        the host so the scatter sees the same index vectors as the JAX
        engine's."""
        store = self.store
        dst_slots = np.asarray(dst_slots, np.int64)
        dtype = store.cfg.dtype
        on_card = store.device.type == "cuda"
        c = self.chunk_pages
        for i in range(0, dst_slots.size, c):
            v = raw[i:i + c]
            t = from_host_raw(_pad_pages(v, _pow2(v.shape[0])), dtype)
            if on_card:
                pinned = torch.empty(t.shape, dtype=dtype, pin_memory=True)
                pinned.copy_(t)
                t = pinned.to(store.device, non_blocking=True)
            store.scatter_device(dst_tier, dst_slots[i:i + c], t)

    def _move_group(self, src_tier: int, dst_tier: int,
                    src_slots: np.ndarray, dst_slots: np.ndarray) -> None:
        """Bulk-move one (src, dst) tier pair's pages by residency."""
        store = self.store
        src_dev = store.is_device_tier(src_tier)
        dst_dev = store.is_device_tier(dst_tier)
        with obs.span("migrate.move_group", src=src_tier, dst=dst_tier,
                      pages=int(len(src_slots))):
            if src_dev and dst_dev:
                staged = store.gather_device(src_tier, src_slots)
                store.scatter_device(dst_tier, dst_slots, staged)
            elif src_dev:
                staged = self._stage_device_to_host(src_tier, src_slots)
                store.host_write_raw(dst_tier, dst_slots, staged)
            elif dst_dev:
                staged = store.host_read_raw(src_tier, src_slots)
                self._stage_host_to_device(dst_tier, dst_slots, staged)
            else:
                staged = store.host_read_raw(src_tier, src_slots)
                store.host_write_raw(dst_tier, dst_slots, staged)

    # -- plan execution --------------------------------------------------------
    def execute_plan(self, plan: MigrationPlan) -> MigrationStats:
        """Apply a reserved plan as one bulk move per source tier (locked
        semantics: commit unconditionally)."""
        st = MigrationStats()
        store = self.store
        for t, n in plan.reads_by_tier.items():
            store.reads_from[int(t)] += int(n)
        k = len(plan)
        if k:
            for src_t in np.unique(plan.src_tiers):
                idx = np.nonzero(plan.src_tiers == src_t)[0]
                self._move_group(int(src_t), plan.dst_tier,
                                 plan.src_slots[idx], plan.dst_slots[idx])
                if not plan.reads_by_tier:
                    store.reads_from[int(src_t)] += idx.size
                st.note_move(int(src_t), plan.dst_tier, idx.size)
            store.commit_moves(plan.pages, plan.dst_tier, plan.dst_slots)
        st.migrated = k + plan.trivial
        st.bytes_moved = (k + plan.trivial) * store.page_nbytes
        _classify(st, plan.dst_tier, st.migrated)
        self.stats.merge(st)
        return st

    # -- locked path -----------------------------------------------------------
    def migrate_locked(self, pages: Iterable[int], dst_tier: int,
                       bank_freq: np.ndarray | None = None,
                       slab_freq: np.ndarray | None = None,
                       reuse_class: np.ndarray | None = None) -> MigrationStats:
        plan = plan_locked(self.store, pages, dst_tier, bank_freq, slab_freq,
                           reuse_class)
        return self.execute_plan(plan)

    # -- optimistic (unlocked DMA) path ---------------------------------------
    def migrate_optimistic(self, pages: Iterable[int], dst_tier: int,
                           bank_freq: np.ndarray | None = None,
                           slab_freq: np.ndarray | None = None,
                           reuse_class: np.ndarray | None = None
                           ) -> MigrationStats:
        """Bulk unlocked copy: stage the whole batch, then commit only
        pages whose version counter did not advance mid-copy; dirtied
        pages retry (destination slots are reserved only after the dirty
        check, so aborted pages reserve nothing)."""
        st = MigrationStats()
        store = self.store
        pending = np.asarray(
            [int(p) for p in dict.fromkeys(int(p) for p in pages)
             if int(store.tier[p]) != dst_tier
             and int(store.slot[p]) != NO_SLOT], np.int64)
        bank_freq = None if bank_freq is None else np.array(bank_freq)
        dst_dev = store.is_device_tier(dst_tier)
        for attempt in range(self.max_retries + 1):
            if pending.size == 0:
                break
            if attempt > 0:
                st.retries += 1
                time.sleep(self.retry_backoff_s * (1 << (attempt - 1)))
            # 1) snapshot versions, 2) bulk copy to staging — one gather /
            # read per source tier, all before the dirty check
            vsnap = store.version[pending].copy()
            src_tiers = store.tier[pending].copy()
            src_slots = store.slot[pending].copy()
            staged = {}                      # src tier -> group buffer
            local_of = np.zeros(pending.size, np.int64)
            groups = {int(t): np.nonzero(src_tiers == t)[0]
                      for t in np.unique(src_tiers)}
            for src_t, idx in groups.items():
                local_of[idx] = np.arange(idx.size)
                if not store.is_device_tier(src_t):
                    staged[src_t] = store.host_read_raw(src_t,
                                                        src_slots[idx])
                elif dst_dev:
                    staged[src_t] = store.gather_device(src_t,
                                                        src_slots[idx])
                else:
                    staged[src_t] = self._stage_device_to_host(
                        src_t, src_slots[idx])
                store.reads_from[src_t] += idx.size
            # 3) dirty check + bulk-commit clean pages
            dirty_mask = store.version[pending] != vsnap
            st.dirty_discards += int(dirty_mask.sum())
            commit_idx: list[int] = []
            dst_slots: list[int] = []
            for i in np.nonzero(~dirty_mask)[0]:
                rc = (None if reuse_class is None
                      else int(reuse_class[pending[i]]))
                s = _alloc_target_slot(store, dst_tier, bank_freq, slab_freq,
                                       rc)
                if s is None:
                    continue          # capacity exhausted: drop this page
                commit_idx.append(int(i))
                dst_slots.append(s)
            if commit_idx:
                idx = np.asarray(commit_idx, np.int64)
                slots = np.asarray(dst_slots, np.int64)
                for src_t in groups:
                    m = src_tiers[idx] == src_t
                    sel = idx[m]
                    if sel.size == 0:
                        continue
                    li = local_of[sel]
                    buf = staged[src_t]
                    if isinstance(buf, np.ndarray):
                        vals = buf[li]
                    else:
                        vals = buf[torch.from_numpy(_pad_idx_np(li)).to(
                            buf.device)]
                    self._commit_group_write(src_t, dst_tier, slots[m], vals)
                    st.note_move(src_t, dst_tier, int(sel.size))
                store.commit_moves(pending[idx], dst_tier, slots)
                st.migrated += idx.size
                st.bytes_moved += idx.size * store.page_nbytes
                _classify(st, dst_tier, idx.size)
            pending = pending[dirty_mask]
        _note_retries_exhausted(st, int(pending.size))
        self.stats.merge(st)
        return st

    def _commit_group_write(self, src_tier: int, dst_tier: int,
                            dst_slots: np.ndarray, vals) -> None:
        """One optimistic-commit group write into the destination tier."""
        store = self.store
        if not store.is_device_tier(dst_tier):
            store.host_write_raw(dst_tier, dst_slots, vals)
        elif store.is_device_tier(src_tier):
            store.scatter_device(dst_tier, dst_slots, vals)
        else:
            self._stage_host_to_device(dst_tier, dst_slots, vals)

    # -- policy-selected execution ---------------------------------------------
    def execute(self, decision: placement.PlacementDecision,
                bank_freq: np.ndarray | None = None,
                slab_freq: np.ndarray | None = None,
                reuse_class: np.ndarray | None = None) -> MigrationStats:
        return execute_decision(self, decision, bank_freq, slab_freq,
                                reuse_class)
