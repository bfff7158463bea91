"""Placement policy: channel allocation, hotness list, Algorithm 2,
channel-bandwidth balancing (paper Sec. 5.2/5.3) — generic over an
N-tier :class:`~repro_torch.core.hierarchy.MemoryHierarchy`.

Channel-allocation principles (Sec. 5.2), generalized:
  1. hot pages (Freq-touched, Thrashing) -> tier 0 (DRAM/HBM), esp. WD;
  2. RD-intensive pages may live in slower tiers without hurting perf;
  3. cold pages sink to the deepest tier (energy + reserve fast capacity).

With more than two tiers the pages tolerant of slower media are
distributed across the intermediate tiers by **per-page utility over
medium costs**: for each intermediate tier (cheapest access cost first)
the pages with the largest latency benefit vs. the deepest tier — their
predicted read/write mix priced through each tier's ``MediumSpec``
Table-1 medium — fill its capacity, and the remainder falls through.
For a two-tier hierarchy this reduces exactly to the paper's original
fast/slow rule.

Migration marking (Fig. 10 step 3): a page is "will-be-migrated" when its
*current* tier disagrees with the tier implied by its *predicted future*
state + hotness; ranking (step 3b): WD_FREQ_H before WD_FREQ_L, then by
hotness score.

Algorithm 2: pick the coldest bank, then the coldest cache slab (excluding
the reserved slabs 0 and 15) whose associated rows in that bank still have
free capacity; walk to the next-coldest slab otherwise.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

from . import patterns, predictor
from .hierarchy import MemoryHierarchy

RESERVED_THRASH_SLAB = 0    # paper: slab 0 isolates Thrashing pages
RESERVED_RARE_SLAB = 15     # paper: slab 15 holds Rarely-touched pages


class PlacementDecision(NamedTuple):
    target_tier: np.ndarray       # int8 [n_pages] tier index
    migrate: np.ndarray           # bool [n_pages] will-be-migrated
    hotness_list: np.ndarray      # int32 [k] page ids, priority-ordered (HL)


def _wants_fastest(wd_code: np.ndarray, hot: np.ndarray, future: np.ndarray,
                   reuse_class: np.ndarray, wear_penalty: float) -> np.ndarray:
    """The three channel-allocation principles: which pages demand tier 0."""
    fast = hot | (future == predictor.WD_FREQ_H) | (future == predictor.WD_FREQ_L)
    # RD-intensive or cold pages may stay slow even if moderately touched;
    # thrashing RD streams explicitly stay slow (they are served through the
    # reserved slab and NVM reads are cheap) unless they are write-heavy.
    rd_stream = (wd_code != patterns.WD) & (reuse_class == patterns.THRASHING)
    fast = fast & ~rd_stream
    if wear_penalty > 0:
        # wear pressure (projected NVM lifetime below the horizon, Sec. 7.1):
        # every currently-WD page is steered to the fast tier regardless of
        # hotness, so the write stream stops consuming NVM endurance — the
        # paper's 40X lifetime mechanism.
        fast = fast | (wd_code == patterns.WD)
    return fast


def _fill_intermediate_tiers(tgt: np.ndarray, tolerant: np.ndarray,
                             hierarchy: MemoryHierarchy,
                             reads: np.ndarray, writes: np.ndarray, *,
                             page_weight: np.ndarray | None = None,
                             energy_aware: bool = False) -> None:
    """Distribute slow-tolerant pages over tiers 1..deepest by utility:
    each intermediate tier (cheapest first) takes the pages whose
    read/write mix gains the most latency vs. the deepest medium, up to
    its slot capacity; everything else stays targeted at the deepest
    tier.  Mutates ``tgt`` in place.

    ``page_weight`` multiplies per-page benefit (tenant QoS weight as a
    utility multiplier, Li et al.), so weighted pages win the
    capacity-constrained intermediate slots.  ``energy_aware`` prices
    tiers by Table-1 access *energy* instead of latency — the power
    governor sets it while over the dynamic-power budget, biasing
    placement toward the low-energy medium."""
    deepest = hierarchy.deepest
    if energy_aware:
        def tier_cost(t):
            m = hierarchy[t].medium
            return m.read_energy_nj + m.write_energy_nj
    else:
        def tier_cost(t):
            return hierarchy[t].read_cost_ns() + hierarchy[t].write_cost_ns()
    mids = sorted(range(1, deepest), key=lambda t: (tier_cost(t), t))
    ids = np.nonzero(tolerant)[0]
    if ids.size == 0:
        return
    r = reads[ids].astype(np.float64)
    w = writes[ids].astype(np.float64)
    deep = hierarchy[deepest]
    remaining = np.ones(ids.size, bool)
    for t in mids:
        spec = hierarchy[t]
        # per-page benefit of tier t over the deepest tier, priced through
        # the Table-1 media (>= 0 when the hierarchy is ordered)
        if energy_aware:
            benefit = (r * (deep.medium.read_energy_nj
                            - spec.medium.read_energy_nj)
                       + w * (deep.medium.write_energy_nj
                              - spec.medium.write_energy_nj))
        else:
            benefit = (r * (deep.read_cost_ns() - spec.read_cost_ns())
                       + w * (deep.write_cost_ns() - spec.write_cost_ns()))
        if page_weight is not None:
            benefit = benefit * page_weight[ids]
        cand = np.nonzero(remaining & (benefit > 0))[0]
        if cand.size == 0:
            continue
        order = np.lexsort((ids[cand], -benefit[cand]))   # benefit desc, id asc
        take = cand[order][:spec.slots]
        tgt[ids[take]] = t
        remaining[take] = False


def target_tier(wd_code: np.ndarray, hot: np.ndarray, future: np.ndarray,
                reuse_class: np.ndarray, wear_penalty: float = 0.0, *,
                hierarchy: MemoryHierarchy | None = None,
                reads: np.ndarray | None = None,
                writes: np.ndarray | None = None,
                page_weight: np.ndarray | None = None,
                energy_aware: bool = False) -> np.ndarray:
    """Target tier index per page.

    Without a ``hierarchy`` (or with a two-tier one) this is exactly the
    paper's fast/slow rule: 0 for pages demanding the fast channel, 1
    (the deepest tier) otherwise.  With more tiers, the slow-tolerant
    pages additionally spread over the intermediate tiers by per-page
    utility over the tiers' ``MediumSpec`` costs (``reads``/``writes``
    supply the access mix; omitted, everything tolerant sinks to the
    deepest tier).  ``page_weight`` / ``energy_aware`` thread the QoS
    utility multiplier and the power-cap energy bias into that fill.
    """
    fast = _wants_fastest(wd_code, hot, future, reuse_class, wear_penalty)
    deepest = 1 if hierarchy is None else hierarchy.deepest
    tgt = np.where(fast, 0, deepest).astype(np.int8)
    if hierarchy is not None and hierarchy.n_tiers > 2 \
            and reads is not None and writes is not None:
        _fill_intermediate_tiers(tgt, ~fast, hierarchy,
                                 np.asarray(reads), np.asarray(writes),
                                 page_weight=page_weight,
                                 energy_aware=energy_aware)
    return tgt


def plan(summary, current_tier: np.ndarray, *, max_migrations: int | None = None,
         wear_penalty: float = 0.0,
         hierarchy: MemoryHierarchy | None = None,
         page_weight: np.ndarray | None = None,
         energy_aware: bool = False) -> PlacementDecision:
    """Fig. 10 steps 2-3: decide targets, mark migrations, rank the HL.

    Under wear pressure (``wear_penalty > 0``) WD pages additionally get a
    ranking boost so their promotions win the migration budget, and the
    target-tier rule pins them to the fast tier (see ``target_tier``).

    ``page_weight`` is the multi-tenant QoS hook (Li et al. page-utility
    model, tenant weight as per-page utility multiplier): it scales the
    hotness score in the migration ranking, scales intermediate-tier fill
    benefit, and pages with weight > 1 *resist demotion* — a demotion
    target (deeper than the current tier) is cancelled for them, so a
    latency-critical tenant's KV pages hold their tier while unweighted
    pages around them sink.  ``energy_aware`` makes the intermediate-tier
    fill rank media by access energy (power-cap response).  With
    ``page_weight`` None/all-ones and ``energy_aware`` False the decision
    is bit-identical to the pre-QoS planner.
    """
    wd_code = np.asarray(summary.wd_code)
    hot = np.asarray(summary.hot)
    future = np.asarray(summary.future)
    reuse = np.asarray(summary.reuse_class)
    hotness = np.asarray(summary.hotness)
    weight = None if page_weight is None \
        else np.asarray(page_weight, dtype=np.float64)

    # the access mix only matters for intermediate-tier assignment, and
    # minimal summary stubs (tests) may not carry raw counters
    reads = getattr(summary, "reads", None)
    writes = getattr(summary, "writes", None)
    tgt = target_tier(
        wd_code, hot, future, reuse, wear_penalty, hierarchy=hierarchy,
        reads=None if reads is None else np.asarray(reads),
        writes=None if writes is None else np.asarray(writes),
        page_weight=weight, energy_aware=energy_aware)
    if weight is not None:
        resist = (weight > 1.0) & (tgt > current_tier)
        tgt = np.where(resist, current_tier, tgt).astype(np.int8)
    migrate = tgt != current_tier
    score = hotness.astype(np.float64)
    if weight is not None:
        score = score * weight
    if wear_penalty > 0:
        score = score + wear_penalty * (wd_code == patterns.WD)

    ids = np.nonzero(migrate)[0]
    # priority: WD_FREQ_H (2) > WD_FREQ_L (1) > UN_WD (0), then score desc.
    order = np.lexsort((-score[ids], -future[ids]))
    hl = ids[order].astype(np.int32)
    if max_migrations is not None:
        hl = hl[:max_migrations]
        keep = np.zeros_like(migrate)
        keep[hl] = True
        migrate = migrate & keep
    return PlacementDecision(tgt, migrate, hl)


def coldest_bank_and_slab(
    bank_freq: np.ndarray,
    slab_freq: np.ndarray,
    rows_free: Callable[[int, int], bool],
    *,
    reserved: tuple[int, ...] = (RESERVED_THRASH_SLAB, RESERVED_RARE_SLAB),
) -> tuple[int, int] | None:
    """Algorithm 2: (cold_bank, cold_slab) with free rows, else None.

    ``rows_free(bank, slab)`` reports whether the rows of ``bank`` associated
    with ``slab`` still have free capacity.
    """
    cold_bank = int(np.argmin(bank_freq))
    slab_order = [int(s) for s in np.argsort(slab_freq, kind="stable")
                  if int(s) not in reserved]
    for slab in slab_order:                    # WHILE rows not free: next slab
        if rows_free(cold_bank, slab):
            return cold_bank, slab
    return None


def slab_for_reuse_class(reuse_class: int) -> int | None:
    """Reserved-slab routing (Sec. 5.3 step 1): Thrashing -> slab 0,
    Rarely-touched -> slab 15, Freq-touched -> policy choice (None)."""
    if reuse_class == patterns.THRASHING:
        return RESERVED_THRASH_SLAB
    if reuse_class == patterns.RARELY_TOUCHED:
        return RESERVED_RARE_SLAB
    return None


class BandwidthBalancer:
    """Channel-bandwidth balancing (Sec. 5.2 'Data Migration Mechanism').

    Spill pages from tier 0 to the next tier down while the fast channel
    is saturated; stop as soon as fast-channel utilization *begins to
    drop* (the paper's stop rule), so fast-channel bandwidth stays
    maximized while the slower channels soak up overflow reads.
    """

    def __init__(self, fast_bw_bound: float, hysteresis: float = 0.02):
        self.bound = fast_bw_bound
        self.hysteresis = hysteresis
        self._last_util: float | None = None
        self.spilling = False

    def update(self, fast_util: float) -> bool:
        """Feed one bandwidth-utilization observation (bytes/s); returns
        whether memos should keep spilling pages off the fast channel."""
        if fast_util >= self.bound:
            self.spilling = True
        elif self._last_util is not None and self.spilling:
            if fast_util < self._last_util * (1.0 - self.hysteresis):
                self.spilling = False  # utilization began to drop -> stop
        self._last_util = fast_util
        return self.spilling

    def spill_candidates(self, wd_code: np.ndarray, hotness: np.ndarray,
                         current_tier: np.ndarray, n: int,
                         exclude_wd: bool = False) -> np.ndarray:
        """Pick n tier-0 pages to spill: RD pages first, then coolest WD
        ones.  ``exclude_wd`` keeps write-dominated pages off the slower
        channels entirely — set while the memos pass is under NVM wear
        pressure."""
        in_fast = current_tier == 0
        rd = in_fast & (wd_code == patterns.RD)
        rd_ids = np.nonzero(rd)[0]
        rd_ids = rd_ids[np.argsort(hotness[rd_ids])]
        if exclude_wd:
            return rd_ids[:n].astype(np.int32)
        wd = in_fast & (wd_code == patterns.WD)
        wd_ids = np.nonzero(wd)[0]
        wd_ids = wd_ids[np.argsort(hotness[wd_ids])]
        return np.concatenate([rd_ids, wd_ids])[:n].astype(np.int32)
