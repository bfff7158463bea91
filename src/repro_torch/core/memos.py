"""MemosManager — the periodic full-hierarchy management loop (Fig. 10),
the torch twin of ``repro.core.memos``'s synchronous pass.

Ties SysMon -> predictor -> placement -> migration together:

  every ``interval`` steps:
    1. close the SysMon sampling pass (classification runs on the device
       where the counters live; one sync hands the summary to the host)
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
the degradation ladder decides whether the pass runs: a pass with
failed migrations demotes it to memos-off, healthy passes re-promote it
(``faults.degradation``).  Both are dead branches while the fault
injector is disarmed.

The asynchronous snapshot -> plan -> commit pipeline and the power
governor of the JAX manager are not ported; the ladder's top rung is
the synchronous pass.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch import obs
from repro_torch.faults.degradation import (RUNG_OFF, RUNG_SYNC,
                                            DegradationLadder)

from . import sysmon as sysmon_mod
from .migration import BatchedMigrationEngine, MigrationStats
from .placement import BandwidthBalancer, plan
from .tiers import TierStore

# consecutive healthy passes before the circuit breaker re-promotes one
# ladder rung (memos-off -> sync)
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
    power_mw: float = 0.0         # summed per-wear-tier dynamic power


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
        self.interval = self.cfg.interval
        self._last_target: np.ndarray | None = None
        self._steps_since = 0
        self._last_pass_step = 0
        self.reports: list[MemosReport] = []
        self.step_count = 0
        # graceful degradation: sync -> memos-off and back after
        # BREAKER_RECOVERY_PASSES healthy passes
        self.ladder = DegradationLadder(
            top=RUNG_SYNC, recovery_passes=BREAKER_RECOVERY_PASSES)

    @property
    def meter(self):
        """Deepest wear-tracked tier's meter (two-tier compat alias)."""
        wt = self.store.hierarchy.wear_tiers()
        return self.meters[wt[-1]] if wt else None

    def maybe_step(self, sm_state: sysmon_mod.SysmonState,
                   fast_bw_util: float = 0.0, steps: int = 1):
        """Call once per serving step — or once per fused decode dispatch
        with ``steps`` = the number of inner steps it covered, so the
        interval stays token-granular across dispatch sizes; fires the
        memos pass on the configured interval.  Returns (new sysmon
        state, report|None)."""
        self.step_count += steps
        self._steps_since += steps
        if self._steps_since < self.interval:
            return sm_state, None
        # a pass can only fire at a call (dispatch) boundary; keep the
        # token-granular cadence exact by carrying the overshoot (capped
        # at one interval: the cadence never exceeds one pass per
        # boundary, so credit beyond that is unspendable)
        self._steps_since = min(self._steps_since - self.interval,
                                self.interval)
        # scrub at the pass boundary: re-verify a budgeted slice of the
        # recorded checksums (detection between a write and the next read)
        self._scrub()
        # memos-off rung: the pass still closes the SysMon window (state
        # stays bounded) and counts healthy so the breaker can climb back
        if self.ladder.rung == RUNG_OFF:
            sm_state, _ = sysmon_mod.end_pass(sm_state)
            self.store.roll_traffic_window()
            self.ladder.record_healthy()
            return sm_state, None
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

    def _spill_dst(self) -> int:
        """Bandwidth-aware spill destination: the backing tier with the
        most channel headroom, skipping capacity-exhausted pools."""
        order = self.store.backing_tier_order()
        for t in order:
            if self.store.alloc[t].n_free > 0:
                return t
        return order[0] if order else self.store.hierarchy.deepest

    def _plan_execute_finish(self, summary, wear_pressure: bool,
                             spilling: bool, spill_dst: int) -> MemosReport:
        """Steps 3-6 of the pass against live state: plan placement,
        execute migrations, spill, close telemetry."""
        penalty = self.cfg.wear_penalty if wear_pressure else 0.0
        decision = plan(summary, self.store.tier.copy(),
                        max_migrations=self.cfg.max_migrations,
                        wear_penalty=penalty, hierarchy=self.store.hierarchy)
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
                exclude_wd=wear_pressure)
            st = self.engine.migrate_optimistic(cands, spill_dst, bank_freq,
                                                slab_freq, reuse)
            spilled = st.migrated
        return self._finish_pass(decision, stats, spilled, summary,
                                 wear_pressure)

    def _finish_pass(self, decision, stats: MigrationStats, spilled: int,
                     summary, wear_pressure: bool) -> MemosReport:
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
            power_mw=float(sum(r.dynamic_power_mw
                               for r in nvm_by_tier.values())),
        )
        self.reports.append(report)
        # ladder health: any failed migration (a group faulted past its
        # retry budget, or a page that failed its pre-flight) demotes one
        # rung; stats.failed only moves under injection, so a fault-free
        # run records healthy passes only
        if stats.failed > 0:
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
        reg.counter("memos.spilled", "bandwidth-balancer spills").inc(
            report.spilled)
        reg.gauge("memos.interval", "current adaptive pass interval").set(
            self.interval)
        reg.gauge("faults.ladder_rung",
                  "degradation rung: 1=sync 0=memos-off").set(
                      self.ladder.rung)
        reg.gauge("memos.bank_imbalance",
                  "stddev of per-bank access frequency").set(
                      report.bank_imbalance)
        if report.nvm_by_tier:
            reg.gauge("power.dynamic_mw",
                      "summed wear-tier dynamic power").set(report.power_mw)
        for k, v in sysmon_mod.summary_metrics(summary).items():
            reg.gauge(f"sysmon.{k}").set(v)
        self.store.publish_metrics(reg)
        for t, nvm in report.nvm_by_tier.items():
            nvm.publish(reg, prefix=f"nvm.t{t}.")
