"""MemosManager — the periodic full-hierarchy management loop (Fig. 10),
the torch twin of ``repro.core.memos``.

Ties SysMon -> predictor -> placement -> migration together:

  every ``interval`` steps:
    1. close the SysMon sampling pass (classification runs on the device
       where the counters live; one device-to-host copy per summary
       field, nine in all, hands the summary to the host)
    2. predict each page's future state (+ Reverse check over K_Len)
    3. mark will-be-migrated pages, rank the hotness list
    4. migrate: locked promotions toward tier 0 for hot/WD pages,
       optimistic bulk demotions toward the slower tiers; destination
       slots via Algorithm 2 in the destination tier's own allocator
    5. bandwidth balancing: spill RD (then coolest WD) pages off the
       fast channel while it is saturated
    6. NVM telemetry: close the energy/lifetime window of every
       wear-tracked tier (``EnergyMeter``, one per tier); when a tier's
       projected lifetime drops below ``lifetime_horizon_years`` the next
       pass plans with a wear penalty.

At every pass boundary a budgeted round-robin scrub re-verifies the
recorded page checksums (quarantining any slot whose bits drifted), and
the degradation ladder decides how the pass runs: overlapped, synchronous
or not at all (``faults.degradation``).  A plan-watchdog fallback or a
pass with failed migrations demotes it one rung, healthy passes
re-promote it.  Both are dead branches while the fault injector is
disarmed.

Asynchronous pipeline (``MemosConfig.async_plan``)
--------------------------------------------------
The synchronous ``run_pass`` blocks the serving loop for the whole pass.
With ``async_plan`` the pass splits into snapshot -> plan -> commit:

  * **snapshot** (dispatch boundary, main thread): close the SysMon pass
    (kernel K7 on the card), hand the summary to the host (nine
    device-to-host copies, one per field),
    read the wear projection (the wear counters are device tensors), and
    snapshot the page table, version counters and cloned allocators
    (:class:`~repro_torch.core.migration.StoreView`) — after this the
    pass holds no tensor;
  * **plan** (worker thread ``memos-plan``, overlapped with the next
    dispatch): placement, Algorithm-2 slot targeting simulated on the
    cloned allocators and spill candidate selection — pure numpy against
    the snapshot.  A CUDA op issued from the worker would run on its
    thread's default stream and synchronise with the dispatch, so the
    worker issues none;
  * **commit** (next dispatch boundary, main thread): page-granular.
    The snapshot opened a dirty-page epoch on the store, so validation
    is a set lookup per planned page.  Reservations land through
    :func:`~repro_torch.core.migration.commit_reservations` (clone
    adoption on a quiet tier, prefix replay otherwise); the clean subset
    of every plan then executes as bulk moves (kernels K3a/K3b, K6,
    ``dequant_gather``), and only pages dirtied mid-plan degrade: their
    reservations are released and the next pass sees them in its fresh
    snapshot.  A pass freed mid-plan drops its void entries.

A watchdog bounds the commit's wait for the worker
(``plan_timeout_s``): a timeout or a worker exception abandons the plan,
runs the pass synchronously against live state and demotes the ladder.

Multi-tenant QoS (``repro_torch.qos``)
--------------------------------------
With ``power_cap_mw`` set, a power governor reads each pass's summed
wear-tier dynamic power; while it throttles, the next plan runs under
power pressure (WD pages pinned fast, energy-ranked intermediate fill,
WD kept out of spills) and the serving engine narrows admission.
``set_page_weight`` records tenant page weights, which multiply
per-page utility in placement; the weight array stays None until a
weight other than 1.0 arrives, so an unweighted run plans exactly as
before.  An overlapped pass snapshots both at ``begin_pass``.
"""
from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from dataclasses import dataclass, field

import numpy as np

from repro_torch import obs
from repro_torch.faults.degradation import (RUNG_OFF, RUNG_OVERLAP,
                                            RUNG_SYNC, DegradationLadder)
from repro_torch.faults.injector import get_injector, note_recovered
from repro_torch.qos.power import PowerGovernor

from . import sysmon as sysmon_mod
from .migration import (BatchedMigrationEngine, MigrationStats, StoreView,
                        commit_reservations, plan_decision, plan_optimistic,
                        subset_plan)
from .placement import BandwidthBalancer, plan
from .tiers import NO_SLOT, TierStore

# consecutive healthy passes before the circuit breaker re-promotes one
# ladder rung (memos-off -> sync -> overlap)
BREAKER_RECOVERY_PASSES = 3
# per-pass budget of recorded page checksums re-verified by the scrub
SCRUB_PAGES = 16


@dataclass
class MemosConfig:
    interval: int = 16            # steps between memos passes
    max_migrations: int | None = 256
    fast_bw_bound: float = 0.9    # fraction of fast-channel peak
    adaptive_interval: bool = True
    interval_growth: float = 1.5  # grow when patterns are stable (Sec. 7.4)
    interval_max: int = 256
    stability_threshold: float = 0.02  # fraction of pages changing target
    # NVM wear feedback (Sec. 7.1): act when any wear-tracked tier's
    # projected lifetime drops below the horizon; None disables feedback.
    lifetime_horizon_years: float | None = None
    wear_penalty: float = 4.0     # HL-ranking boost for WD pages under pressure
    pass_window_s: float = 1.0    # notional wall-clock span of one pass
    # overlap the plan phase with the next dispatch on a worker thread
    # (snapshot -> plan -> commit; see module docstring)
    async_plan: bool = False
    # -- fault tolerance (repro_torch.faults) -----------------------------
    # watchdog bound on joining the worker-thread plan at commit time; a
    # timeout (or any worker exception) falls back to a synchronous pass
    # against live state and demotes the degradation ladder.  None =
    # wait forever (no watchdog).
    plan_timeout_s: float | None = 30.0
    # -- power cap (repro_torch.qos.power) --------------------------------
    # budget on the summed per-wear-tier ``NvmReport.dynamic_power_mw``;
    # while over it the governor raises a throttle level that shrinks
    # serving-engine batch admission and plans the next pass under power
    # pressure.  None disables the governor entirely.
    power_cap_mw: float | None = None


@dataclass
class MemosReport:
    step: int
    migrations: MigrationStats
    n_marked: int
    fast_pages: int               # pages resident in tier 0
    slow_pages: int               # pages resident in the deepest tier
    bank_imbalance: float
    spilled: int = 0
    tier_pages: list[int] = field(default_factory=list)  # per-tier residency
    nvm: object | None = None     # deepest wear-tracked tier's NvmReport
    nvm_by_tier: dict = field(default_factory=dict)  # tier -> NvmReport
    wear_pressure: bool = False   # wear penalty applied to this pass's plan
    power_pressure: bool = False  # pass planned under the power governor
    power_throttle: int = 0       # governor throttle level after this pass
    power_mw: float = 0.0         # summed per-wear-tier dynamic power
    committed_async: bool = False  # pass went through the overlapped commit
    plan_conflict: bool = False    # some planned pages were stale (degraded)
    pages_committed: int = 0      # planned pages committed by this pass
    pages_degraded: int = 0       # planned pages left for the next pass
    pages_dropped: int = 0        # planned pages freed mid-plan (not conflicts)
    plan_ms: float = 0.0          # wall time of the (worker-thread) plan phase
    # fraction of the plan phase hidden under the overlapped dispatch
    # (1.0 = fully hidden, 0.0 = the commit waited for the whole plan);
    # None for synchronous passes
    overlap_efficiency: float | None = None
    # non-None when this pass recovered from a plan-phase fault: the
    # failure class ("timeout", "InjectedPlanFault", ...) whose watchdog
    # fallback produced this (synchronous) result
    fault_fallback: str | None = None

    def to_dict(self) -> dict:
        """JSON-ready nested dict (MigrationStats and every per-tier
        NvmReport through their own ``to_dict``); round-trips through
        :meth:`from_dict`.  The JAX report's keys, in its order."""
        return {
            "step": self.step,
            "migrations": self.migrations.to_dict(),
            "n_marked": self.n_marked,
            "fast_pages": self.fast_pages,
            "slow_pages": self.slow_pages,
            "bank_imbalance": self.bank_imbalance,
            "spilled": self.spilled,
            "tier_pages": list(self.tier_pages),
            "nvm": self.nvm.to_dict() if self.nvm is not None else None,
            "nvm_by_tier": {str(t): r.to_dict()
                            for t, r in self.nvm_by_tier.items()},
            "wear_pressure": self.wear_pressure,
            "power_pressure": self.power_pressure,
            "power_throttle": self.power_throttle,
            "power_mw": self.power_mw,
            "committed_async": self.committed_async,
            "plan_conflict": self.plan_conflict,
            "pages_committed": self.pages_committed,
            "pages_degraded": self.pages_degraded,
            "pages_dropped": self.pages_dropped,
            "plan_ms": self.plan_ms,
            "overlap_efficiency": self.overlap_efficiency,
            "fault_fallback": self.fault_fallback,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MemosReport":
        from repro_torch.nvm.energy import NvmReport
        nvm_by_tier = {int(t): NvmReport(**r)
                       for t, r in (d.get("nvm_by_tier") or {}).items()}
        nvm = NvmReport(**d["nvm"]) if d.get("nvm") is not None else None
        # the deepest tier's report aliases the by-tier entry, as built
        if nvm is not None:
            for r in nvm_by_tier.values():
                if r == nvm:
                    nvm = r
                    break
        return cls(
            step=d["step"],
            migrations=MigrationStats.from_dict(d["migrations"]),
            n_marked=d["n_marked"], fast_pages=d["fast_pages"],
            slow_pages=d["slow_pages"],
            bank_imbalance=d["bank_imbalance"], spilled=d["spilled"],
            tier_pages=list(d["tier_pages"]), nvm=nvm,
            nvm_by_tier=nvm_by_tier, wear_pressure=d["wear_pressure"],
            power_pressure=d.get("power_pressure", False),
            power_throttle=d.get("power_throttle", 0),
            power_mw=d.get("power_mw", 0.0),
            committed_async=d["committed_async"],
            plan_conflict=d["plan_conflict"],
            pages_committed=d["pages_committed"],
            pages_degraded=d["pages_degraded"],
            pages_dropped=d.get("pages_dropped", 0),
            plan_ms=d.get("plan_ms", 0.0),
            overlap_efficiency=d.get("overlap_efficiency"),
            fault_fallback=d.get("fault_fallback"),
        )

    def flat_metrics(self) -> dict:
        """Flattened scalar leaves (`tier{i}_pages` per tier, migration
        stats inlined, per-wear-tier energy under ``nvm.t{t}.``)."""
        m = self.migrations
        out = {
            "step": self.step, "migrated": m.migrated,
            "to_fast": m.to_fast, "to_slow": m.to_slow,
            "bytes_moved": m.bytes_moved,
            "dirty_discards": m.dirty_discards, "retries": m.retries,
            "n_marked": self.n_marked, "spilled": self.spilled,
            "bank_imbalance": self.bank_imbalance,
            "wear_pressure": int(self.wear_pressure),
            "power_pressure": int(self.power_pressure),
            "power_throttle": self.power_throttle,
            "power_mw": self.power_mw,
            "committed_async": int(self.committed_async),
            "plan_conflict": int(self.plan_conflict),
            "pages_committed": self.pages_committed,
            "pages_degraded": self.pages_degraded,
            "pages_dropped": self.pages_dropped,
            "plan_ms": self.plan_ms,
            "fault_fallback": int(self.fault_fallback is not None),
        }
        if self.overlap_efficiency is not None:
            out["overlap_efficiency"] = self.overlap_efficiency
        for t, n in enumerate(self.tier_pages):
            out[f"tier{t}_pages"] = n
        for t, r in self.nvm_by_tier.items():
            d = r.to_dict()
            for k in ("slow_writes", "wear_max", "read_energy_mj",
                      "write_energy_mj", "dynamic_power_mw",
                      "lifetime_years_actual"):
                out[f"nvm.t{t}.{k}"] = d[k]
        return out


def aggregate_reports(reports: list[MemosReport]) -> dict:
    """Sum the countable leaves of a report list (migrated, spilled,
    pages committed/degraded/dropped, bytes moved) and carry the last
    pass's state leaves."""
    agg = {"passes": len(reports), "migrated": 0, "to_fast": 0,
           "to_slow": 0, "bytes_moved": 0, "spilled": 0,
           "pages_committed": 0, "pages_degraded": 0, "pages_dropped": 0}
    effs = []
    for r in reports:
        f = r.flat_metrics()
        for k in ("migrated", "to_fast", "to_slow", "bytes_moved",
                  "spilled", "pages_committed", "pages_degraded",
                  "pages_dropped"):
            agg[k] += f[k]
        if r.overlap_efficiency is not None:
            effs.append(r.overlap_efficiency)
    if effs:
        agg["overlap_efficiency_mean"] = float(np.mean(effs))
    if reports:
        last = reports[-1]
        agg["tier_pages"] = list(last.tier_pages)
        agg["nvm_last"] = (last.to_dict()["nvm"]
                           if last.nvm is not None else None)
    return agg


@dataclass
class _PlanTicket:
    """One in-flight asynchronous pass: the snapshot (numpy only) plus
    the worker future that resolves to (decision, plans, spill_plan)."""
    step: int
    summary: object               # PassSummary with numpy leaves
    view: StoreView
    wear_pressure: bool
    spilling: bool
    spill_dst: int
    power_pressure: bool = False
    page_weight: np.ndarray | None = None   # snapshot of tenant weights
    future: Future | None = None
    # worker-thread plan phase wall-clock bounds (monotonic ns), recorded
    # unconditionally so the overlap-efficiency metric works without
    # tracing
    plan_t0_ns: int = 0
    plan_t1_ns: int = 0


class MemosManager:
    def __init__(self, store: TierStore, cfg: MemosConfig | None = None):
        # lazy import: repro_torch.nvm depends on core.costmodel
        from repro_torch.nvm.energy import EnergyMeter
        self.store = store
        self.cfg = cfg or MemosConfig()
        self.engine = BatchedMigrationEngine(store)
        self.balancer = BandwidthBalancer(self.cfg.fast_bw_bound)
        # one energy meter per wear-tracked tier
        self.meters = {t: EnergyMeter(store, tier=t,
                                      window_s=self.cfg.pass_window_s)
                       for t in store.hierarchy.wear_tiers()}
        # power-cap governor: fed the summed per-wear-tier dynamic power
        # at the end of every pass; its throttle level shrinks the
        # engine's admission and puts the next plan under power pressure
        self.governor = None
        if self.cfg.power_cap_mw is not None:
            self.governor = PowerGovernor(budget_mw=self.cfg.power_cap_mw)
        # per-page tenant utility weights (lazy: None, and the planner
        # unchanged, until a weight other than 1.0 arrives)
        self._page_weight: np.ndarray | None = None
        self.interval = self.cfg.interval
        self._last_target: np.ndarray | None = None
        self._steps_since = 0
        self._last_pass_step = 0
        self.reports: list[MemosReport] = []
        self.step_count = 0
        # async pipeline state
        self._executor: ThreadPoolExecutor | None = None
        self._ticket: _PlanTicket | None = None
        # graceful degradation: overlap -> sync -> memos-off, and back
        # after BREAKER_RECOVERY_PASSES healthy passes
        self.ladder = DegradationLadder(
            top=RUNG_OVERLAP if self.cfg.async_plan else RUNG_SYNC,
            recovery_passes=BREAKER_RECOVERY_PASSES)
        # page-granular commit accounting: a partially committed pass
        # counts in both, once per page
        self.pages_committed = 0      # planned pages committed async
        self.pages_degraded = 0       # planned pages dirtied mid-plan
        self.pages_dropped = 0        # planned pages freed mid-plan
        # overlap efficiency: how much of the worker's plan time was
        # hidden under the dispatch between snapshot and commit
        self.plan_ns_total = 0
        self.plan_hidden_ns_total = 0
        # test hook: called with (manager, decision, plans) between the
        # worker join and validation — simulates writes landing mid-plan
        self._mid_plan_hook = None

    @property
    def meter(self):
        """Deepest wear-tracked tier's meter (two-tier compat alias)."""
        wt = self.store.hierarchy.wear_tiers()
        return self.meters[wt[-1]] if wt else None

    @property
    def overlap_efficiency(self) -> float | None:
        """Lifetime fraction of async plan time hidden under overlapped
        dispatches (None before any async pass commits)."""
        if not self.plan_ns_total:
            return None
        return self.plan_hidden_ns_total / self.plan_ns_total

    def maybe_step(self, sm_state: sysmon_mod.SysmonState,
                   fast_bw_util: float = 0.0, steps: int = 1,
                   on_commit=None):
        """Call once per serving step — or once per fused decode dispatch
        with ``steps`` = the number of inner steps it covered, so the
        interval stays token-granular across dispatch sizes; fires the
        memos pass on the configured interval.  Returns (new sysmon
        state, report|None).  In async mode the report belongs to the
        *previous* boundary's pass, committed here after overlapping with
        the dispatch in between; ``on_commit(report)`` runs between that
        commit and the next snapshot, so the caller's reaction to the
        pass (the serving engine re-promoting demoted active pages) is
        inside the next plan's snapshot instead of dirtying it."""
        report = self.commit_pending()
        if report is not None and on_commit is not None:
            on_commit(report)
        self.step_count += steps
        self._steps_since += steps
        if self._steps_since < self.interval:
            return sm_state, report
        # a pass can only fire at a call (dispatch) boundary; keep the
        # token-granular cadence exact by carrying the overshoot (capped
        # at one interval: the cadence never exceeds one pass per
        # boundary, so credit beyond that is unspendable)
        self._steps_since = min(self._steps_since - self.interval,
                                self.interval)
        # scrub at the pass boundary: re-verify a budgeted slice of the
        # recorded checksums (detection between a write and the next read)
        self._scrub()
        # degradation ladder: overlap -> sync -> memos-off.  At OFF the
        # pass still closes the SysMon window (state stays bounded) and
        # counts healthy so the breaker can climb back
        rung = self.ladder.rung
        if rung == RUNG_OFF:
            sm_state, _ = sysmon_mod.end_pass(sm_state)
            self.store.roll_traffic_window()
            self.ladder.record_healthy()
            return sm_state, report
        if self.cfg.async_plan and rung >= RUNG_OVERLAP:
            return self.begin_pass(sm_state, fast_bw_util), report
        return self.run_pass(sm_state, fast_bw_util)

    def _scrub(self) -> None:
        integ = self.store.integrity
        if not integ.enabled:
            return
        for t, s in integ.scrub(self.store, SCRUB_PAGES):
            self.store.quarantine_slot(t, s, reason="scrub")

    def run_pass(self, sm_state: sysmon_mod.SysmonState,
                 fast_bw_util: float = 0.0):
        with obs.span("memos.pass_sync", step=self.step_count):
            # 1-2) close the pass; classification + prediction on device
            sm_state, summary = sysmon_mod.end_pass(sm_state)
            report = self._plan_execute_finish(
                summary.numpy(), self._wear_pressure(),
                self.balancer.update(fast_bw_util), self._spill_dst())
        return sm_state, report

    def _wear_pressure(self) -> bool:
        """Whether any wear-tracked tier's projected lifetime (from the
        live counters) has dropped below the horizon."""
        if not (self.meters and self.cfg.lifetime_horizon_years):
            return False
        return any(m.project_lifetime() < self.cfg.lifetime_horizon_years
                   for m in self.meters.values())

    def _power_pressure(self) -> bool:
        """Whether the power governor is throttling (a pass's dynamic
        power exceeded the budget and the throttle has not fully
        released)."""
        return self.governor is not None and self.governor.pressure

    def set_page_weight(self, pages, weight: float) -> None:
        """Record the tenant utility weight of a set of logical pages.
        The weight array is made on the first weight other than 1.0, so
        an unweighted workload keeps ``page_weight=None`` and the
        planner's decisions unchanged."""
        if self._page_weight is None:
            if weight == 1.0:
                return
            self._page_weight = np.ones(self.store.tier.shape[0],
                                        dtype=np.float64)
        self._page_weight[np.asarray(pages, dtype=np.int64)] = float(weight)

    def _spill_dst(self) -> int:
        """Bandwidth-aware spill destination: the backing tier with the
        most channel headroom, skipping capacity-exhausted pools."""
        order = self.store.backing_tier_order()
        for t in order:
            if self.store.alloc[t].n_free > 0:
                return t
        return order[0] if order else self.store.hierarchy.deepest

    def _plan_execute_finish(self, summary, wear_pressure: bool,
                             spilling: bool, spill_dst: int, *,
                             fault_fallback: str | None = None
                             ) -> MemosReport:
        """Steps 3-6 of the pass against live state: plan placement,
        execute migrations, spill, close telemetry — the synchronous
        path (also the watchdog's fallback).  Under power pressure WD
        pages pin fast (the wear-penalty path), WD stays out of spills
        and intermediate-tier fill ranks media by access energy."""
        power_pressure = self._power_pressure()
        pressure = wear_pressure or power_pressure
        penalty = self.cfg.wear_penalty if pressure else 0.0
        decision = plan(summary, self.store.tier.copy(),
                        max_migrations=self.cfg.max_migrations,
                        wear_penalty=penalty, hierarchy=self.store.hierarchy,
                        page_weight=self._page_weight,
                        energy_aware=power_pressure)
        bank_freq = np.asarray(summary.bank_freq)
        slab_freq = np.asarray(summary.slab_freq)
        reuse = np.asarray(summary.reuse_class)

        # 4) migrate
        stats = self.engine.execute(decision, bank_freq, slab_freq, reuse)

        # 5) bandwidth balancing
        spilled = 0
        if spilling:
            cands = self.balancer.spill_candidates(
                np.asarray(summary.wd_code), np.asarray(summary.hotness),
                self.store.tier, n=self.cfg.max_migrations or 64,
                exclude_wd=pressure)
            st = self.engine.migrate_optimistic(cands, spill_dst, bank_freq,
                                                slab_freq, reuse)
            spilled = st.migrated
        return self._finish_pass(decision, stats, spilled, summary,
                                 wear_pressure,
                                 power_pressure=power_pressure,
                                 fault_fallback=fault_fallback)

    def _finish_pass(self, decision, stats: MigrationStats, spilled: int,
                     summary, wear_pressure: bool, *,
                     power_pressure: bool = False,
                     committed_async: bool = False,
                     pages_committed: int = 0,
                     pages_degraded: int = 0,
                     pages_dropped: int = 0,
                     plan_ms: float = 0.0,
                     overlap_efficiency: float | None = None,
                     fault_fallback: str | None = None) -> MemosReport:
        """Close the pass: adaptive interval, telemetry windows, report."""
        tgt = np.asarray(decision.target_tier)
        if self.cfg.adaptive_interval and self._last_target is not None:
            changed = float(np.mean(tgt != self._last_target))
            if changed < self.cfg.stability_threshold:
                self.interval = min(int(self.interval
                                        * self.cfg.interval_growth),
                                    self.cfg.interval_max)
            else:
                self.interval = self.cfg.interval
        self._last_target = tgt

        # 6) close every wear-tracked tier's telemetry window, scaled by
        # the steps this pass actually covered
        nvm_by_tier = {}
        if self.meters:
            steps = self.step_count - self._last_pass_step
            window = (self.cfg.pass_window_s * steps / self.cfg.interval
                      if steps > 0 else self.cfg.pass_window_s)
            nvm_by_tier = {t: m.end_pass(window_s=window)
                           for t, m in self.meters.items()}
        self._last_pass_step = self.step_count
        self.store.roll_traffic_window()

        # power-cap control loop: the governor reads the summed dynamic
        # power of every wear-tracked tier; its throttle level shapes the
        # next pass's plan and the engine's admission width
        power_mw = float(sum(r.dynamic_power_mw
                             for r in nvm_by_tier.values()))
        if self.governor is not None and nvm_by_tier:
            self.governor.observe(power_mw)

        bank_freq = np.asarray(summary.bank_freq)
        tier_pages = [int((self.store.tier == t).sum())
                      for t in range(self.store.n_tiers)]
        wt = self.store.hierarchy.wear_tiers()
        report = MemosReport(
            step=self.step_count,
            migrations=stats,
            n_marked=int(decision.migrate.sum()),
            fast_pages=tier_pages[0],
            slow_pages=tier_pages[-1],
            bank_imbalance=float(np.std(bank_freq)),
            spilled=spilled,
            tier_pages=tier_pages,
            nvm=nvm_by_tier.get(wt[-1]) if wt else None,
            nvm_by_tier=nvm_by_tier,
            wear_pressure=wear_pressure,
            power_pressure=power_pressure,
            power_throttle=(self.governor.throttle
                            if self.governor is not None else 0),
            power_mw=power_mw,
            committed_async=committed_async,
            plan_conflict=pages_degraded > 0,
            pages_committed=pages_committed,
            pages_degraded=pages_degraded,
            pages_dropped=pages_dropped,
            plan_ms=plan_ms,
            overlap_efficiency=overlap_efficiency,
            fault_fallback=fault_fallback,
        )
        self.reports.append(report)
        # ladder health: a watchdog fallback or any failed migration (a
        # group faulted past its retry budget, or a page that failed its
        # pre-flight) demotes one rung; both move only under injection,
        # so a fault-free run records healthy passes only
        if fault_fallback is not None:
            self.ladder.record_failure(f"plan:{fault_fallback}")
        elif stats.failed > 0:
            self.ladder.record_failure("migration")
        else:
            self.ladder.record_healthy()
        self._publish_metrics(report, summary)
        return report

    def _publish_metrics(self, report: MemosReport, summary) -> None:
        """Publish this pass into the process metrics registry."""
        reg = obs.get_registry()
        reg.counter("memos.passes", "memos passes completed").inc()
        reg.counter("memos.pages_migrated",
                    "pages moved across tiers").inc(report.migrations.migrated)
        reg.counter("memos.migration_bytes",
                    "bytes moved across tiers").inc(
                        report.migrations.bytes_moved)
        reg.counter("memos.pages_committed",
                    "async-plan pages committed").inc(report.pages_committed)
        reg.counter("memos.pages_degraded",
                    "async-plan pages degraded to next pass").inc(
                        report.pages_degraded)
        reg.counter("memos.pages_dropped",
                    "async-plan pages voided by mid-plan frees").inc(
                        report.pages_dropped)
        reg.counter("memos.spilled", "bandwidth-balancer spills").inc(
            report.spilled)
        if report.plan_ms > 0:
            reg.histogram("memos.plan_latency_s",
                          "worker-thread plan phase wall time").observe(
                              report.plan_ms / 1e3)
        if report.overlap_efficiency is not None:
            reg.histogram(
                "memos.overlap_efficiency",
                "fraction of plan time hidden under dispatch").observe(
                    report.overlap_efficiency)
        reg.gauge("memos.interval", "current adaptive pass interval").set(
            self.interval)
        reg.gauge("faults.ladder_rung",
                  "degradation rung: 2=overlap 1=sync 0=memos-off").set(
                      self.ladder.rung)
        reg.gauge("memos.bank_imbalance",
                  "stddev of per-bank access frequency").set(
                      report.bank_imbalance)
        if report.nvm_by_tier:
            reg.gauge("power.dynamic_mw",
                      "summed wear-tier dynamic power").set(report.power_mw)
        if self.governor is not None:
            reg.gauge("power.throttle",
                      "power-governor admission shrink level").set(
                          self.governor.throttle)
            reg.gauge("power.budget_mw", "dynamic-power budget").set(
                self.governor.budget_mw)
            reg.gauge("power.over_budget_passes",
                      "passes whose power reading exceeded the budget").set(
                          self.governor.over_budget_passes)
        for k, v in sysmon_mod.summary_metrics(summary).items():
            reg.gauge(f"sysmon.{k}").set(v)
        self.store.publish_metrics(reg)
        for t, nvm in report.nvm_by_tier.items():
            nvm.publish(reg, prefix=f"nvm.t{t}.")

    # =========================================================================
    # asynchronous pipeline: snapshot -> plan (worker) -> commit
    # =========================================================================

    def begin_pass(self, sm_state: sysmon_mod.SysmonState,
                   fast_bw_util: float = 0.0) -> sysmon_mod.SysmonState:
        """Snapshot phase, at a dispatch boundary: close the SysMon pass,
        freeze the placement-visible store state, and hand the plan to
        the worker thread.  Returns the reset SysMon state at once so the
        next dispatch launches while the worker plans."""
        assert self._ticket is None, "previous plan not committed"
        with obs.span("memos.snapshot", step=self.step_count):
            # classification ran on the device (K7); nine device-to-host
            # copies, one per summary field, hand it to the host so the
            # worker touches no tensor
            sm_state, summary = sysmon_mod.end_pass(sm_state)
            ticket = _PlanTicket(
                step=self.step_count,
                summary=summary.numpy(),
                view=StoreView(self.store),
                wear_pressure=self._wear_pressure(),
                spilling=self.balancer.update(fast_bw_util),
                spill_dst=self._spill_dst(),
                power_pressure=self._power_pressure(),
                # a copy: a weight set mid-plan must not reach this plan
                page_weight=(None if self._page_weight is None
                             else self._page_weight.copy()),
            )
            ticket.future = self._submit_plan(ticket)
            self._ticket = ticket
        return sm_state

    def _submit_plan(self, ticket: _PlanTicket) -> Future:
        """Hand the plan to the worker pool, respawning the executor once
        if it died (watchdog shutdown, external kill); if the respawn
        also cannot accept work, return a pre-failed future so the next
        commit takes the synchronous fallback instead of deadlocking."""
        for _ in range(2):
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="memos-plan")
            try:
                return self._executor.submit(self._plan_job, ticket)
            except RuntimeError:          # executor already shut down
                self._executor = None
        f: Future = Future()
        f.set_exception(RuntimeError("memos plan executor unavailable"))
        return f

    def _plan_job(self, t: _PlanTicket):
        """Worker-thread plan phase: placement + Algorithm-2 slot
        targeting + spill candidates, all against the snapshot
        (reservations simulated on the cloned allocators).  Pure numpy:
        no tensor, no device work, no live-store access."""
        # the plan's wall clock is recorded unconditionally (two
        # monotonic_ns calls): overlap efficiency must work untraced
        t.plan_t0_ns = time.monotonic_ns()
        with obs.span("memos.plan", step=t.step):
            get_injector().maybe_plan_fault()
            pressure = t.wear_pressure or t.power_pressure
            penalty = self.cfg.wear_penalty if pressure else 0.0
            decision = plan(t.summary, t.view.tier.copy(),
                            max_migrations=self.cfg.max_migrations,
                            wear_penalty=penalty,
                            hierarchy=self.store.hierarchy,
                            page_weight=t.page_weight,
                            energy_aware=t.power_pressure)
            bank_freq = np.asarray(t.summary.bank_freq)
            slab_freq = np.asarray(t.summary.slab_freq)
            reuse = np.asarray(t.summary.reuse_class)
            plans = plan_decision(t.view, decision, bank_freq, slab_freq,
                                  reuse)
            spill_plan = None
            if t.spilling:
                cands = self.balancer.spill_candidates(
                    np.asarray(t.summary.wd_code),
                    np.asarray(t.summary.hotness),
                    t.view.tier, n=self.cfg.max_migrations or 64,
                    exclude_wd=pressure)
                # candidates come from the snapshot's tier table, so
                # exclude pages this pass already plans to move (the
                # synchronous path picks candidates after migrating)
                planned = {int(p) for pl in plans for p in pl.pages}
                cands = np.asarray(
                    [p for p in cands if int(p) not in planned], np.int64)
                spill_plan = plan_optimistic(t.view, cands, t.spill_dst,
                                             bank_freq, slab_freq, reuse)
        t.plan_t1_ns = time.monotonic_ns()
        return decision, plans, spill_plan

    def commit_pending(self) -> MemosReport | None:
        """Commit phase, at the next dispatch boundary — page-granular:
        join the worker (bounded by the watchdog), close the dirty-page
        epoch the snapshot opened, land the reservations, and execute the
        clean subset of every plan.  Only pages dirtied mid-plan degrade
        (their reservations are released; the next pass sees them in its
        own snapshot); pages freed mid-plan drop.  No-op when no plan is
        in flight."""
        if self._ticket is None:
            return None
        t, self._ticket = self._ticket, None
        # plan time elapsed before the result was asked for was hidden
        # under the dispatch; time blocked in result() is exposed
        t_commit0 = time.monotonic_ns()
        try:
            decision, plans, spill_plan = t.future.result(
                timeout=self.cfg.plan_timeout_s)
        except FutureTimeout:
            return self._plan_fault_fallback(t, "timeout")
        except Exception as e:        # the worker raised (injected or real)
            return self._plan_fault_fallback(t, type(e).__name__)
        with obs.span("memos.commit", step=t.step) as sp:
            if self._mid_plan_hook is not None:
                self._mid_plan_hook(self, decision, plans)
            all_plans = plans + ([spill_plan] if spill_plan is not None
                                 else [])
            # pages whose version/tier/slot changed since the snapshot,
            # recorded by the store as the dispatch ran
            dirty = self.store.end_dirty_epoch()
            landed = commit_reservations(self.store, t.view, all_plans)

            stats = MigrationStats()
            spilled = 0
            committed = degraded = dropped = 0
            for pl, ok in zip(all_plans, landed):
                keep = ok.copy()
                if len(pl):
                    if dirty:
                        stale = np.asarray(
                            [int(p) in dirty for p in pl.pages])
                        keep &= ~stale
                        # stale pages no longer allocated were freed
                        # mid-plan (a retired sequence): the entry is
                        # void, not deferred work
                        freed = np.asarray(
                            [int(self.store.slot[int(p)]) == NO_SLOT
                             for p in pl.pages])
                        dropped += int((stale & freed).sum())
                    # release the reservations of pages that degrade or
                    # drop (a page the replay had no room for holds none)
                    for i in np.nonzero(ok & ~keep)[0]:
                        self.store.alloc[pl.dst_tier].free(
                            int(pl.dst_slots[i]), 0)
                committed += int(keep.sum())
                degraded += len(pl) - int(keep.sum())
                st = self.engine.execute_plan(subset_plan(pl, keep))
                if pl is spill_plan:
                    spilled = st.migrated
                else:
                    stats.merge(st)
            degraded -= dropped
            self.pages_committed += committed
            self.pages_degraded += degraded
            self.pages_dropped += dropped
            sp.set(pages_committed=committed, pages_degraded=degraded,
                   pages_dropped=dropped)

        plan_dur = max(t.plan_t1_ns - t.plan_t0_ns, 0)
        hidden = min(max(t_commit0 - t.plan_t0_ns, 0), plan_dur)
        eff = hidden / plan_dur if plan_dur > 0 else 1.0
        self.plan_ns_total += plan_dur
        self.plan_hidden_ns_total += hidden
        return self._finish_pass(decision, stats, spilled, t.summary,
                                 t.wear_pressure,
                                 power_pressure=t.power_pressure,
                                 committed_async=True,
                                 pages_committed=committed,
                                 pages_degraded=degraded,
                                 pages_dropped=dropped,
                                 plan_ms=plan_dur / 1e6,
                                 overlap_efficiency=eff)

    def _plan_fault_fallback(self, t: _PlanTicket,
                             reason: str) -> MemosReport:
        """Watchdog path: the worker's plan hung past ``plan_timeout_s``
        or died with an exception.  Abandon the future (a hung worker
        keeps its thread; the executor is shut down without waiting and
        respawned by the next ``begin_pass``), close the dirty-page
        epoch, and run the whole pass synchronously against live state.
        The pass records the recovery and demotes the ladder."""
        with obs.span("memos.plan_fallback", step=t.step, reason=reason):
            t.future.cancel()
            if self._executor is not None:
                self._executor.shutdown(wait=False, cancel_futures=True)
                self._executor = None
            self.store.end_dirty_epoch()
            note_recovered("plan_fallback")
            return self._plan_execute_finish(t.summary, t.wear_pressure,
                                             t.spilling, t.spill_dst,
                                             fault_fallback=reason)

    def flush(self) -> MemosReport | None:
        """Commit any in-flight plan (end of serving / shutdown)."""
        return self.commit_pending()

    def close(self) -> None:
        self.flush()
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
