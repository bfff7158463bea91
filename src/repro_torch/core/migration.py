"""Migration engines (paper Sec. 6.3, Fig. 10 step 4): plan/execute split,
generic over the tiers of a :class:`~repro_torch.core.hierarchy.MemoryHierarchy`
— the torch twin of ``repro.core.migration``.

  * **plan** (host) — reserve each page's destination slot per
    Algorithm 2 (coldest bank, then coldest non-reserved slab;
    reserved-slab routing for Thrashing/Rarely-touched pages) in the
    destination tier's sub-buddy allocator.  The output is a
    ``MigrationPlan``: parallel arrays of (page, src tier, src slot,
    dst slot).
  * **execute** (device) — bulk data movement per (source, destination)
    residency pair:

      - between device-addressable tiers (HBM pools and the pinned-host
        pool, which the kernels address in place): ``page_gather`` out
        of the source pool, ``page_scatter`` into the destination pool;
      - device -> host: ``page_gather`` into contiguous device staging,
        then chunked non-blocking copies into pinned host buffers; the
        host reads them only after the stream has synchronised;
      - host -> device: chunked uploads through pinned buffers, then an
        in-place ``page_scatter``;
      - host -> host: one vectorized numpy copy.

Host tiers move pages in their storage format (bfloat16 as uint16 bits),
so a round trip through the slow tier is bit-exact.  Pages bound for an
int8 tier are quantized on the card by kernel K6 straight from the
source pool, and only int8 bytes and scales travel on (the numpy pool
stores them as given); pages leaving an int8 tier cross as int8 and are
dequantized on the card (``dequant_gather``).  Pages that leave a numpy
host tier for or from the int8 tier without a device tier on the other
end convert in numpy (``TierStore.host_read_for``).

While the fault injector is armed, every bulk move retries injected
transient faults with exponential backoff and fails closed past the cap
(pages stay where they were, reservations return), and every page read
out of a host-class tier is first verified against its checksum — a
corrupt page is quarantined, never copied forward.

Two engines implement execute: ``BatchedMigrationEngine``, the bulk
mover above, and ``MigrationEngine``, the per-page **reference** loop
over ``TierStore.move_page`` / ``read_page`` kept as the tests' parity
oracle; the memos manager drives the bulk mover.  Both expose the paper's two
paths: ``locked`` (synchronous, commit unconditionally; promotions
toward tier 0) and ``optimistic`` (snapshot version counters, copy
without blocking writers, commit only pages whose version did not
advance, retry dirtied pages; bulk demotions).  The allocator call
order is the JAX engines', so both packages land every page in the
same slot.

The asynchronous memos pass plans against a :class:`StoreView` — a
numpy snapshot of the page table, version counters and cloned
allocators — on a worker thread (``plan_decision``: the same grouping
and allocator call order as ``execute_decision``), and lands the
simulated reservations at the next dispatch boundary with
``commit_reservations``: clone adoption on a tier that saw no
interleaved allocator call, per-call replay patched to the live slots
otherwise.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.faults.errors import TransientMigrationFault
from repro_torch.faults.injector import get_injector, note_recovered
from repro_torch.kernels.page_quant import dequant_gather

from . import placement
from .tiers import (NO_SLOT, QuantPages, TierStore, _pad_idx_np, _pad_pages,
                    _pow2, from_host_raw, map_pages, to_host_raw)


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

    @classmethod
    def from_dict(cls, d: dict) -> "MigrationStats":
        by_pair = {}
        for k, n in d.get("by_pair", {}).items():
            s, _, dst = k.partition("->")
            by_pair[(int(s), int(dst))] = int(n)
        return cls(
            migrated=int(d.get("migrated", 0)),
            dirty_discards=int(d.get("dirty_discards", 0)),
            retries=int(d.get("retries", 0)),
            retries_exhausted=int(d.get("retries_exhausted", 0)),
            failed=int(d.get("failed", 0)),
            bytes_moved=int(d.get("bytes_moved", 0)),
            to_fast=int(d.get("to_fast", 0)),
            to_slow=int(d.get("to_slow", 0)),
            by_pair=by_pair,
        )


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
    reserved each slot (-1 = any color): a plan produced against a
    :class:`StoreView` has its reservations *simulated* on cloned
    allocators, and ``commit_reservations`` lands them on the live store
    at commit time.  ``reads_by_tier`` carries the staging read charge
    for optimistic plans (the unlocked copy stages every pending page,
    including ones later dropped for capacity, so the asynchronous
    commit charges the reads the synchronous path would).
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


class StoreView:
    """Immutable-world facade for the asynchronous plan phase.

    Snapshots the placement-visible store state (page table, version
    counters, cloned per-tier allocators) at a dispatch boundary — numpy
    and plain Python only, so the plan worker touches no tensor and
    issues no device work.  ``plan_locked`` / ``plan_optimistic`` run
    against it (they only touch ``tier``/``slot``/``alloc``), simulating
    Algorithm-2 reservations off-thread while the next dispatch runs.
    Creating the view also records each tier allocator's generation
    counter and opens the store's dirty-page epoch: the commit validates
    per page against the epoch's dirty set and adopts any clone whose
    tier saw no interleaved allocator call."""

    def __init__(self, store: TierStore):
        self.tier = store.tier.copy()
        self.slot = store.slot.copy()
        self.version = store.version.copy()
        self.alloc = [a.clone() for a in store.alloc]
        self.alloc_gen = [a.gen for a in store.alloc]
        self.hierarchy = store.hierarchy
        self.n_tiers = store.n_tiers
        store.begin_dirty_epoch()


def subset_plan(plan: MigrationPlan, keep: np.ndarray) -> MigrationPlan:
    """The sub-plan of ``plan`` restricted to the kept pages (bool mask);
    ``trivial`` and ``reads_by_tier`` carry over whole."""
    keep = np.asarray(keep, bool)
    if keep.all():
        return plan
    return MigrationPlan(
        dst_tier=plan.dst_tier,
        pages=plan.pages[keep],
        src_tiers=plan.src_tiers[keep],
        src_slots=plan.src_slots[keep],
        dst_slots=plan.dst_slots[keep],
        trivial=plan.trivial,
        colors=None if plan.colors is None else plan.colors[keep],
        masks=None if plan.masks is None else plan.masks[keep],
        reads_by_tier=plan.reads_by_tier,
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


def plan_decision(store, decision: placement.PlacementDecision,
                  bank_freq: np.ndarray | None = None,
                  slab_freq: np.ndarray | None = None,
                  reuse_class: np.ndarray | None = None) -> list[MigrationPlan]:
    """Reserve every migration of a ``PlacementDecision`` without moving
    data: the same destination grouping and allocator call order as
    ``execute_decision`` (promotions per dst tier shallowest-first via
    the locked sequence, then demotions via the optimistic sequence), so
    a conflict-free commit lands every page in exactly the slot the
    synchronous pass would have picked.  ``store`` may be a live
    ``TierStore`` or a :class:`StoreView` snapshot."""
    promos, demos = _group_decision(store, decision)
    plans: list[MigrationPlan] = []
    for dst in range(store.n_tiers):
        if promos[dst]:
            plans.append(plan_locked(store, promos[dst], dst, bank_freq,
                                     slab_freq, reuse_class))
    for dst in range(store.n_tiers):
        if demos[dst]:
            plans.append(plan_optimistic(store, demos[dst], dst, bank_freq,
                                         slab_freq, reuse_class))
    return plans


def _replay_calls(store: TierStore, plan: MigrationPlan) -> np.ndarray:
    """Re-issue one plan's recorded allocator calls on the live store, in
    order.  Interleaved allocator activity (tail-page provisioning,
    promotion frees) means the live free lists no longer match the
    snapshot clones, so a call may land on a *different* slot than the
    plan simulated — not a conflict: the page is still clean, and the
    slot obtained is the one a synchronous pass planning at this
    boundary would take, so the plan is patched to it in place.  Only a
    capacity failure (the tier full even after the any-color fallback)
    drops a reservation.  Returns the bool landed-mask."""
    assert plan.colors is not None and plan.masks is not None, \
        "replay needs a plan with recorded allocator calls"
    ok = np.zeros(len(plan), bool)
    for i in range(len(plan)):
        c, m = int(plan.colors[i]), int(plan.masks[i])
        s = store.alloc[plan.dst_tier].alloc(
            0, None if c < 0 else c, None if m < 0 else m)
        if s is None and c >= 0:
            s = store.alloc[plan.dst_tier].alloc(0, None)
        if s is None:
            continue
        plan.dst_slots[i] = s
        ok[i] = True
    return ok


def commit_reservations(store: TierStore, view: StoreView,
                        plans: list[MigrationPlan]) -> list[np.ndarray]:
    """Make the live allocators hold each plan's reservations; returns
    one bool landed-mask per plan (False = no capacity left for that
    page at commit time).  A destination tier whose live generation
    counter still equals the snapshot's saw no allocator call during the
    dispatch, so the view's clone — which already holds every simulated
    reservation — becomes the live allocator (O(1), slots exactly as
    simulated).  Tiers with interleaved activity replay the recorded
    calls (:func:`_replay_calls`)."""
    landed = [np.zeros(len(pl), bool) for pl in plans]
    by_tier: dict[int, list[int]] = {}
    for i, pl in enumerate(plans):
        by_tier.setdefault(pl.dst_tier, []).append(i)
    for t, idxs in by_tier.items():
        if store.alloc[t].gen == view.alloc_gen[t]:
            store.alloc[t] = view.alloc[t]
            for i in idxs:
                landed[i][:] = True
        else:
            for i in idxs:        # plan order == simulation order
                landed[i] = _replay_calls(store, plans[i])
    return landed


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
# reference engine (per-page loop) — the parity oracle
# =============================================================================

class MigrationEngine:
    """The per-page reference engine: one ``TierStore.move_page`` per
    locked page, one ``read_page`` per staged optimistic page.  Same
    constructor and ``migrate_locked`` / ``migrate_optimistic`` /
    ``execute`` signatures as :class:`BatchedMigrationEngine`, and the
    same allocator calls in the same order, so both land every page in
    the same slot; it has no ``execute_plan`` and so cannot serve the
    asynchronous pass."""

    def __init__(self, store: TierStore, *, max_retries: int = 3,
                 retry_backoff_s: float = 1e-3):
        self.store = store
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.stats = MigrationStats()

    # -- locked path -----------------------------------------------------------
    def migrate_locked(self, pages: Iterable[int], dst_tier: int,
                       bank_freq: np.ndarray | None = None,
                       slab_freq: np.ndarray | None = None,
                       reuse_class: np.ndarray | None = None) -> MigrationStats:
        st = MigrationStats()
        store = self.store
        bank_freq = None if bank_freq is None else np.array(bank_freq)
        for p in pages:
            src_tier = int(store.tier[p])
            rc = None if reuse_class is None else int(reuse_class[p])
            color, mask = target_color(store, dst_tier, bank_freq, slab_freq,
                                       rc)
            if not store.move_page(int(p), dst_tier, color, mask):
                continue
            st.migrated += 1
            st.bytes_moved += store.page_nbytes
            _classify(st, dst_tier, 1)
            if src_tier != dst_tier:           # trivial moves shift no bytes
                st.note_move(src_tier, dst_tier)
            if bank_freq is not None:
                # account the move so subsequent picks spread across banks
                cfg = store.alloc[dst_tier].cfg
                bank_freq[cfg.bank_of(int(store.slot[p]))
                          % len(bank_freq)] += 1
        self.stats.merge(st)
        return st

    # -- optimistic (unlocked DMA) path ---------------------------------------
    def migrate_optimistic(self, pages: Iterable[int], dst_tier: int,
                           bank_freq: np.ndarray | None = None,
                           slab_freq: np.ndarray | None = None,
                           reuse_class: np.ndarray | None = None,
                           concurrent_writer: Callable[[], None] | None = None
                           ) -> MigrationStats:
        """Copy without locking; commit only pages not dirtied mid-copy.
        ``concurrent_writer`` is a test hook invoked once between the
        copy and the version re-check, standing in for writes that land
        while the copy is in flight."""
        st = MigrationStats()
        store = self.store
        pending = [int(p) for p in dict.fromkeys(int(p) for p in pages)
                   if int(store.tier[p]) != dst_tier
                   and int(store.slot[p]) != NO_SLOT]
        bank_freq = None if bank_freq is None else np.array(bank_freq)
        for attempt in range(self.max_retries + 1):
            if not pending:
                break
            if attempt > 0:
                st.retries += 1
                time.sleep(self.retry_backoff_s * (1 << (attempt - 1)))
            # 1) snapshot versions, 2) copy every pending page to staging
            vsnap = {p: int(store.version[p]) for p in pending}
            staged = {p: store.read_page(p) for p in pending}
            if concurrent_writer is not None:
                concurrent_writer()
                concurrent_writer = None   # the writer fires once
            # 3) dirty check + commit clean pages
            dirty: list[int] = []
            for p in pending:
                if int(store.version[p]) != vsnap[p]:
                    dirty.append(p)        # discarded: retried next attempt
                    st.dirty_discards += 1
                    continue
                rc = None if reuse_class is None else int(reuse_class[p])
                new_slot = _alloc_target_slot(store, dst_tier, bank_freq,
                                              slab_freq, rc)
                if new_slot is None:
                    continue
                old_tier, old_slot = int(store.tier[p]), int(store.slot[p])
                if store.is_device_tier(dst_tier):
                    store.pools[dst_tier].write_one(new_slot, staged[p])
                else:
                    store._host_write(dst_tier, new_slot, staged[p])
                store.alloc[old_tier].free(old_slot, 0)
                store.tier[p] = dst_tier
                store.slot[p] = new_slot
                store._mark_dirty(p)
                store.traffic[(old_tier, dst_tier)] += store.page_nbytes
                st.migrated += 1
                st.bytes_moved += store.page_nbytes
                _classify(st, dst_tier, 1)
                st.note_move(old_tier, dst_tier)
            pending = dirty
        _note_retries_exhausted(st, len(pending))
        self.stats.merge(st)
        return st

    # -- policy-selected execution ---------------------------------------------
    def execute(self, decision: placement.PlacementDecision,
                bank_freq: np.ndarray | None = None,
                slab_freq: np.ndarray | None = None,
                reuse_class: np.ndarray | None = None) -> MigrationStats:
        return execute_decision(self, decision, bank_freq, slab_freq,
                                reuse_class)


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
    def _stage_device_to_host(self, src_tier: int, slots: np.ndarray,
                              quantize: bool = False):
        """Gather a device tier's slots into device staging
        (``page_gather``, or K6 when ``quantize``: the destination is the
        int8 tier) chunk by chunk, copy each chunk into a pinned host
        buffer without blocking, then synchronise the stream once before
        numpy reads any of them.  Returns the pages in host storage
        format (QuantPages when quantized)."""
        store = self.store
        slots = np.asarray(slots, np.int64)
        on_card = store.device.type == "cuda"

        def to_host(g):
            host = torch.empty(g.shape, dtype=g.dtype, pin_memory=on_card)
            return host.copy_(g, non_blocking=on_card)
        bufs = []
        for i in range(0, slots.size, self.chunk_pages):
            chunk = slots[i:i + self.chunk_pages]
            g = store.gather_device(src_tier, chunk, quantize=quantize)
            bufs.append((map_pages(to_host, g), chunk.size))
        if on_card:
            # the copies are asynchronous: numpy must not read the pinned
            # buffers before they have landed
            torch.cuda.current_stream(store.device).synchronize()
        # gathers come back pow2-padded; slice to true counts
        if quantize:
            return QuantPages(
                np.concatenate([h.q.numpy()[:n] for h, n in bufs]),
                np.concatenate([h.scale.numpy()[:n] for h, n in bufs]))
        return np.concatenate([to_host_raw(h)[:n] for h, n in bufs])

    def _stage_host_to_device(self, dst_tier: int, dst_slots: np.ndarray,
                              raw) -> None:
        """Upload host pages (storage format) chunk by chunk through
        pinned buffers and scatter each chunk into its planned device
        slots (``page_scatter``, in place).  int8 pages (QuantPages)
        cross as int8 and scales and are dequantized on the card
        (``dequant_gather``) unless the destination is the int8 tier.  Chunks are pow2-padded on the host so the
        scatter sees the same index vectors as the JAX engine's."""
        store = self.store
        dst_slots = np.asarray(dst_slots, np.int64)
        dtype = store.cfg.dtype
        on_card = store.device.type == "cuda"

        def upload(t):
            if not on_card:
                return t
            pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            pinned.copy_(t)
            return pinned.to(store.device, non_blocking=True)
        c = self.chunk_pages
        for i in range(0, dst_slots.size, c):
            v = _pad_pages(raw[i:i + c], _pow2(min(c, dst_slots.size - i)))
            if isinstance(v, QuantPages):
                t = map_pages(lambda a: upload(torch.from_numpy(a)), v)
                if not store.is_quantized_tier(dst_tier):
                    idx = torch.arange(v.shape[0], dtype=torch.int32,
                                       device=store.device)
                    t = dequant_gather(t.q, t.scale, idx, dtype)
            else:
                t = upload(from_host_raw(v, dtype))
            store.scatter_device(dst_tier, dst_slots[i:i + c], t)

    def _with_retries(self, src_tier: int, dst_tier: int, pages: int) -> None:
        """The injected-fault gate ahead of one bulk write: retry with
        exponential backoff up to ``max_retries``; past the cap the
        :class:`TransientMigrationFault` escapes and the caller drops the
        group.  Injection fires before any data moves, so a failed
        attempt never leaves a half-written group."""
        inj = get_injector()
        attempts = (self.max_retries + 1) if inj.enabled else 1
        for a in range(attempts):
            try:
                inj.maybe_migration_fault(src_tier, dst_tier, pages)
            except TransientMigrationFault:
                if a + 1 >= attempts:
                    raise
                time.sleep(self.retry_backoff_s * (1 << a))
                continue
            if a:
                note_recovered("migrate_retry")
            return

    def _move_group(self, src_tier: int, dst_tier: int,
                    src_slots: np.ndarray, dst_slots: np.ndarray) -> None:
        """Bulk-move one (src, dst) tier pair's pages by residency:
        device-addressable pairs (HBM and pinned-host pools) move with
        the gather/scatter kernels alone, the device <-> numpy-host pairs
        stage through pinned buffers, host -> host is one numpy copy."""
        store = self.store
        src_dev = store.is_addressable_tier(src_tier)
        dst_dev = store.is_addressable_tier(dst_tier)
        quant = store.is_quantized_tier(dst_tier)
        with obs.span("migrate.move_group", src=src_tier, dst=dst_tier,
                      pages=int(len(src_slots))):
            self._with_retries(src_tier, dst_tier, int(len(src_slots)))
            if src_dev and dst_dev:
                staged = store.gather_device(src_tier, src_slots,
                                             quantize=quant)
                store.scatter_device(dst_tier, dst_slots, staged)
            elif src_dev:
                staged = self._stage_device_to_host(src_tier, src_slots,
                                                    quantize=quant)
                store.host_write_raw(dst_tier, dst_slots, staged)
            elif dst_dev:
                staged = store.host_read_for(src_tier, src_slots, dst_tier)
                self._stage_host_to_device(dst_tier, dst_slots, staged)
            else:
                staged = store.host_read_for(src_tier, src_slots, dst_tier)
                store.host_write_raw(dst_tier, dst_slots, staged)

    # -- integrity pre-flight --------------------------------------------------
    def _preflight_verify(self, plan: MigrationPlan,
                          st: MigrationStats) -> MigrationPlan:
        """Verify the checksums of the plan's host-class source pages
        before any data moves: a corrupt page's slot is quarantined (its
        owner fails cleanly), its reserved destination slot freed, and
        the plan shrunk — corrupt bits are never copied into a faster
        tier.  No-op while integrity is disarmed."""
        store = self.store
        if not store.integrity.enabled or len(plan) == 0:
            return plan
        keep = np.ones(len(plan), bool)
        for src_t in np.unique(plan.src_tiers):
            t = int(src_t)
            if store.is_device_tier(t):
                continue
            idx = np.nonzero(plan.src_tiers == src_t)[0]
            bad = set(store.integrity.verify(store, t, plan.src_slots[idx]))
            for i in idx:
                if int(plan.src_slots[i]) in bad:
                    keep[i] = False
                    st.failed += 1
                    store.quarantine_slot(t, int(plan.src_slots[i]),
                                          "promotion-preflight")
                    store.alloc[plan.dst_tier].free(int(plan.dst_slots[i]), 0)
        return plan if keep.all() else subset_plan(plan, keep)

    # -- plan execution --------------------------------------------------------
    def execute_plan(self, plan: MigrationPlan) -> MigrationStats:
        """Apply a reserved plan as one bulk move per source tier (locked
        semantics: commit unconditionally).  Groups whose move faults past
        the retry cap are dropped from the commit: their pages stay in
        the source tier and their reservations are returned."""
        st = MigrationStats()
        store = self.store
        for t, n in plan.reads_by_tier.items():
            store.reads_from[int(t)] += int(n)
        plan = self._preflight_verify(plan, st)
        k = len(plan)
        if k:
            keep = np.ones(k, bool)
            for src_t in np.unique(plan.src_tiers):
                idx = np.nonzero(plan.src_tiers == src_t)[0]
                try:
                    self._move_group(int(src_t), plan.dst_tier,
                                     plan.src_slots[idx], plan.dst_slots[idx])
                except TransientMigrationFault:
                    keep[idx] = False
                    st.failed += idx.size
                    for i in idx:
                        store.alloc[plan.dst_tier].free(
                            int(plan.dst_slots[i]), 0)
                    continue
                if not plan.reads_by_tier:
                    store.reads_from[int(src_t)] += idx.size
                st.note_move(int(src_t), plan.dst_tier, idx.size)
            if not keep.all():
                plan = subset_plan(plan, keep)
                k = len(plan)
            if k:
                store.commit_moves(plan.pages, plan.dst_tier,
                                   plan.dst_slots)
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
        if store.integrity.enabled and pending.size:
            # pre-flight: quarantine corrupt host-class source pages (their
            # slot drops to NO_SLOT) before anything is staged
            for t in np.unique(store.tier[pending]):
                t = int(t)
                if store.is_device_tier(t):
                    continue
                sel = pending[store.tier[pending] == t]
                for s in store.integrity.verify(store, t, store.slot[sel]):
                    st.failed += 1
                    store.quarantine_slot(t, int(s), "promotion-preflight")
            pending = pending[store.slot[pending] != NO_SLOT]
        bank_freq = None if bank_freq is None else np.array(bank_freq)
        dst_dev = store.is_addressable_tier(dst_tier)
        quant = store.is_quantized_tier(dst_tier)
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
                if not store.is_addressable_tier(src_t):
                    staged[src_t] = store.host_read_for(
                        src_t, src_slots[idx], dst_tier)
                elif dst_dev:
                    staged[src_t] = store.gather_device(
                        src_t, src_slots[idx], quantize=quant)
                else:
                    staged[src_t] = self._stage_device_to_host(
                        src_t, src_slots[idx], quantize=quant)
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
                ok = np.ones(idx.size, bool)
                for src_t in groups:
                    m = src_tiers[idx] == src_t
                    sel = idx[m]
                    if sel.size == 0:
                        continue
                    li = local_of[sel]
                    buf = staged[src_t]
                    first = buf.q if isinstance(buf, QuantPages) else buf
                    if isinstance(first, np.ndarray):
                        vals = buf[li]
                    else:
                        vals = buf[torch.from_numpy(_pad_idx_np(li)).to(
                            store.device)]
                    try:
                        self._commit_group_write(src_t, dst_tier, slots[m],
                                                 vals)
                    except TransientMigrationFault:
                        # faulted past the retry cap: return the
                        # reservations, leave the pages where they are
                        ok[m] = False
                        st.failed += int(sel.size)
                        for s_ in slots[m]:
                            store.alloc[dst_tier].free(int(s_), 0)
                        continue
                    st.note_move(src_t, dst_tier, int(sel.size))
                if not ok.all():
                    idx, slots = idx[ok], slots[ok]
                if idx.size:
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
        """One optimistic-commit group write into the destination tier,
        behind the same injected-fault retry gate as :meth:`_move_group`."""
        self._with_retries(src_tier, dst_tier, int(len(dst_slots)))
        store = self.store
        if not store.is_addressable_tier(dst_tier):
            store.host_write_raw(dst_tier, dst_slots, vals)
        elif store.is_addressable_tier(src_tier):
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
