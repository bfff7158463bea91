"""Per-pass NVM energy / lifetime accounting (paper Sec. 7.1, Table 1).

Builds on the ``MediumParams`` constants in ``core/costmodel.py``: every
memos pass the ``EnergyMeter`` snapshots the TierStore's slow-tier
counters (app + migration writes from the wear tracker, reads from the
store's counters), converts them to dynamic energy via the Table-1
per-access energies, adds the standby floor, and projects NVM lifetime
from the *measured* wear distribution — the max-wear slot sets the actual
lifetime, the mean-wear slot the ideal (perfectly leveled) bound, and
their ratio is the wear imbalance the Start-Gap leveler exists to close.

Accumulated reports feed ``MemosReport.nvm`` (the policy's wear-pressure
signal) and ``benchmarks/fig_wear_energy.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.costmodel import (LEVELING_EFFICIENCY, NVM,
                                        MediumParams,
                                        lifetime_years_from_wear,
                                        page_access_energy_nj,
                                        standby_power_w)


@dataclass
class NvmReport:
    """One pass worth of NVM-side telemetry."""

    passes: int                    # completed passes including this one
    window_s: float                # notional wall-clock span of one pass
    slow_reads: int                # page reads served by the slow tier
    slow_writes: int               # page writes absorbed (app + migration)
    leveling_writes: int           # extra writes spent rotating the pool
    read_energy_mj: float
    write_energy_mj: float
    dynamic_power_mw: float        # over this pass's window
    standby_w: float
    capacity_gb: float
    wear_max: int                  # writes on the worst physical slot (total)
    wear_mean: float
    wear_imbalance: float          # max / mean (1.0 = perfectly leveled)
    lifetime_years_actual: float   # endurance / max-wear rate
    lifetime_years_ideal: float    # endurance * 95% / mean-wear rate

    def to_dict(self) -> dict:
        return {k: (float(v) if isinstance(v, float) else v)
                for k, v in self.__dict__.items()}

    def publish(self, reg, prefix: str = "nvm.") -> None:
        """Publish this pass into an ``obs.MetricsRegistry``: energy as
        counters (per-pass mJ accumulates across passes), wear / power /
        lifetime as gauges."""
        reg.counter(f"{prefix}read_energy_mj",
                    "dynamic read energy (mJ)").inc(self.read_energy_mj)
        reg.counter(f"{prefix}write_energy_mj",
                    "dynamic write energy (mJ)").inc(self.write_energy_mj)
        reg.counter(f"{prefix}slow_writes",
                    "page writes absorbed this tier").inc(self.slow_writes)
        reg.counter(f"{prefix}leveling_writes",
                    "Start-Gap rotation writes").inc(self.leveling_writes)
        reg.gauge(f"{prefix}wear_max",
                  "writes on the worst physical slot").set(self.wear_max)
        reg.gauge(f"{prefix}wear_imbalance",
                  "max/mean wear ratio").set(self.wear_imbalance)
        reg.gauge(f"{prefix}dynamic_power_mw",
                  "dynamic power over the pass window").set(
                      self.dynamic_power_mw)
        lt = self.lifetime_years_actual
        if lt != float("inf"):
            reg.gauge(f"{prefix}lifetime_years",
                      "projected endurance lifetime").set(lt)


class EnergyMeter:
    """Accumulates one tier's access counts pass by pass.

    One meter attaches to one wear-tracked (or at least host-resident)
    tier — ``tier`` defaults to the store's deepest wear-tracked tier
    (falling back to the deepest tier), and ``medium`` defaults to that
    tier's ``MediumSpec`` medium, so a plain ``EnergyMeter(store)`` on a
    two-tier hierarchy behaves exactly as before.

    ``end_pass()`` closes the current window and returns its ``NvmReport``;
    ``project_lifetime()`` reads the live wear counters mid-pass (the
    placement policy's wear-rate signal) without closing the window.
    """

    def __init__(self, store, medium: MediumParams | None = None,
                 window_s: float = 1.0, *, tier: int | None = None):
        self.store = store
        if tier is None:
            wt = store.hierarchy.wear_tiers()
            tier = wt[-1] if wt else store.hierarchy.deepest
        self.tier = int(tier)
        self.medium = medium or store.hierarchy[self.tier].medium
        self.window_s = float(window_s)   # default span of one pass
        self.passes = 0
        self.elapsed = 0.0                # accumulated closed-window seconds
        self.reports: list[NvmReport] = []
        self._snap = self._counters()

    @property
    def _wear(self):
        return self.store.wear_by_tier.get(self.tier)

    def _counters(self) -> dict:
        w = self._wear
        return {
            "slow_writes": (w.writes_total if w is not None
                            else self.store.writes_to[self.tier]),
            "slow_reads": self.store.reads_from[self.tier],
            "leveling_writes": (w.leveling_writes if w is not None else 0),
        }

    @property
    def capacity_bytes(self) -> int:
        return self.store.hierarchy[self.tier].slots * self.store.page_nbytes

    def elapsed_s(self) -> float:
        return self.elapsed

    def project_lifetime(self) -> float:
        """Years until the worst physical slot exhausts endurance, from the
        live wear counters and elapsed (notional) time.  inf before any
        wear has accumulated or when wear is untracked."""
        w = self._wear
        if w is None:
            return float("inf")
        return lifetime_years_from_wear(w.max_wear(), self.elapsed_s(),
                                        self.medium)

    def end_pass(self, window_s: float | None = None) -> NvmReport:
        """Close the current accounting window.  ``window_s`` overrides the
        default span — the memos manager passes the pass's *actual* step
        span so adaptive interval growth doesn't inflate the wear rate."""
        window_s = self.window_s if window_s is None else float(window_s)
        self.passes += 1
        self.elapsed += window_s
        cur = self._counters()
        d = {k: cur[k] - self._snap[k] for k in cur}
        self._snap = cur
        m = self.medium
        page_b = self.store.page_nbytes
        # leveling swaps are real NVM writes: charge their energy too
        writes = d["slow_writes"] + d["leveling_writes"]
        read_nj = d["slow_reads"] * page_access_energy_nj(m, page_b, False)
        write_nj = writes * page_access_energy_nj(m, page_b, True)
        w = self._wear
        wear_max = w.max_wear() if w is not None else 0
        wear_mean = w.mean_wear() if w is not None else 0.0
        elapsed = self.elapsed_s()
        report = NvmReport(
            passes=self.passes,
            window_s=window_s,
            slow_reads=d["slow_reads"],
            slow_writes=d["slow_writes"],
            leveling_writes=d["leveling_writes"],
            read_energy_mj=read_nj * 1e-6,
            write_energy_mj=write_nj * 1e-6,
            dynamic_power_mw=(read_nj + write_nj) * 1e-9
            / max(window_s, 1e-12) * 1e3,
            standby_w=standby_power_w(self.capacity_bytes / 2**30, m),
            capacity_gb=self.capacity_bytes / 2**30,
            wear_max=wear_max,
            wear_mean=wear_mean,
            wear_imbalance=wear_max / max(wear_mean, 1e-12),
            lifetime_years_actual=lifetime_years_from_wear(
                wear_max, elapsed, m),
            lifetime_years_ideal=lifetime_years_from_wear(
                wear_mean, elapsed, m, efficiency=LEVELING_EFFICIENCY),
        )
        self.reports.append(report)
        return report
