"""Latency / energy / lifetime cost model (paper Table 1 + Sec. 7.1).

Used by the evaluation benchmarks to score placements exactly the way the
paper's DRAMSim2-based emulation does, plus a TPU-constants profile for the
HBM/host-tier projection.

Paper Table 1:
  DRAM: trcd=10ns trp=10ns twr=10ns, r/w energy 51.2/51.2 nJ, standby 1 W/GB
  NVM : trcd=20ns trp=23ns twr=160ns, r/w energy 102.4/512 nJ,
        standby 0.1 W/GB, endurance 1e6
Lifetime model (Sec. 7.1): 64 B wear blocks, Start-Gap style leveling at
95% of ideal cell lifetime.
"""
from __future__ import annotations

from dataclasses import dataclass

SECONDS_PER_YEAR = 365.25 * 24 * 3600


@dataclass(frozen=True)
class MediumParams:
    name: str
    trcd_ns: float
    trp_ns: float
    twr_ns: float
    read_energy_nj: float
    write_energy_nj: float
    standby_w_per_gb: float
    endurance: float | None = None  # writes per cell; None = unlimited


# --- paper Table 1 -----------------------------------------------------------
DRAM = MediumParams("DRAM", trcd_ns=10, trp_ns=10, twr_ns=10,
                    read_energy_nj=51.2, write_energy_nj=51.2,
                    standby_w_per_gb=1.0)
NVM = MediumParams("NVM", trcd_ns=20, trp_ns=23, twr_ns=160,
                   read_energy_nj=102.4, write_energy_nj=512.0,
                   standby_w_per_gb=0.1, endurance=1e6)

# --- TPU-projection profile (v5e-class, DESIGN.md Sec. 2) ---------------------
# "latency" for a page-granular access = page_bytes / bandwidth; we express
# the fast/slow asymmetry via effective per-access service times for a 4 KB
# page equivalent.  HBM 819 GB/s; host via PCIe Gen3-class ~12 GB/s.
HBM = MediumParams("HBM", trcd_ns=4.9, trp_ns=0.0, twr_ns=4.9,
                   read_energy_nj=4.1, write_energy_nj=4.1,
                   standby_w_per_gb=0.04)
HOST = MediumParams("HOST", trcd_ns=333.0, trp_ns=0.0, twr_ns=333.0,
                    read_energy_nj=62.0, write_energy_nj=62.0,
                    standby_w_per_gb=0.005)

WEAR_BLOCK_BYTES = 64
LEVELING_EFFICIENCY = 0.95  # Start-Gap


def startgap_interval(efficiency: float = LEVELING_EFFICIENCY) -> int:
    """Demand writes between Start-Gap moves for a target leveling
    efficiency: each gap move spends overhead on 1/(interval+1) of the
    write stream, so efficiency = interval / (interval + 1)."""
    assert 0.0 < efficiency < 1.0
    return max(1, round(efficiency / (1.0 - efficiency)))


def page_access_energy_nj(m: MediumParams, page_bytes: int,
                          is_write: bool) -> float:
    """Energy for one page-granular access: Table-1 energies are per
    64 B array access, and a page access touches each of its wear blocks
    once."""
    per_access = m.write_energy_nj if is_write else m.read_energy_nj
    return (page_bytes / WEAR_BLOCK_BYTES) * per_access


def lifetime_years_from_wear(wear_writes: float, elapsed_s: float,
                             m: MediumParams = NVM,
                             efficiency: float = 1.0) -> float:
    """Lifetime projection from *measured* wear: ``wear_writes`` writes
    landed on a wear block over ``elapsed_s`` seconds; extrapolate to the
    time that block hits endurance.  The online counterpart of
    ``nvm_lifetime_years`` (which models the write stream analytically)."""
    if m.endurance is None or wear_writes <= 0 or elapsed_s <= 0:
        return float("inf")
    rate = wear_writes / elapsed_s
    return efficiency * m.endurance / rate / SECONDS_PER_YEAR


@dataclass
class AccessCounts:
    reads: float = 0.0
    writes: float = 0.0

    @property
    def total(self) -> float:
        return self.reads + self.writes


def access_latency_ns(m: MediumParams, is_write: bool,
                      row_conflict_rate: float = 0.0) -> float:
    """Mean per-access latency: activate + (write-recovery if write), plus a
    precharge penalty on row-buffer conflicts (bank imbalance raises this)."""
    base = m.trcd_ns + (m.twr_ns if is_write else 0.0)
    return base + row_conflict_rate * m.trp_ns


def mean_latency_ns(counts_fast: AccessCounts, counts_slow: AccessCounts,
                    fast: MediumParams = DRAM, slow: MediumParams = NVM,
                    conflict_fast: float = 0.0, conflict_slow: float = 0.0) -> float:
    num = (counts_fast.reads * access_latency_ns(fast, False, conflict_fast)
           + counts_fast.writes * access_latency_ns(fast, True, conflict_fast)
           + counts_slow.reads * access_latency_ns(slow, False, conflict_slow)
           + counts_slow.writes * access_latency_ns(slow, True, conflict_slow))
    den = counts_fast.total + counts_slow.total
    return num / max(den, 1.0)


def slow_tier_latency_ns(counts_slow: AccessCounts,
                         slow: MediumParams = NVM,
                         conflict: float = 0.0) -> float:
    """NVM-side average latency (paper reports this per-channel)."""
    num = (counts_slow.reads * access_latency_ns(slow, False, conflict)
           + counts_slow.writes * access_latency_ns(slow, True, conflict))
    return num / max(counts_slow.total, 1.0)


def dynamic_energy_mw(counts: AccessCounts, m: MediumParams,
                      window_s: float) -> float:
    """Average dynamic power (mW) over the window, as in Sec. 7.1."""
    nj = counts.reads * m.read_energy_nj + counts.writes * m.write_energy_nj
    return (nj * 1e-9) / max(window_s, 1e-12) * 1e3


def standby_power_w(capacity_gb: float, m: MediumParams) -> float:
    return capacity_gb * m.standby_w_per_gb


def nvm_lifetime_years(write_bytes_per_s: float, capacity_bytes: float,
                       m: MediumParams = NVM,
                       hot_block_fraction: float = 1.0) -> float:
    """Sec. 7.1 lifetime model.

    With ideal leveling every 64 B wear block absorbs an equal share of the
    write stream; ``hot_block_fraction`` < 1 models unleveled skew (writes
    concentrated on a fraction of blocks, as in the no-memos baselines).
    """
    if m.endurance is None:
        return float("inf")
    blocks = capacity_bytes / WEAR_BLOCK_BYTES
    writes_per_block_s = (write_bytes_per_s / WEAR_BLOCK_BYTES) / max(
        blocks * hot_block_fraction, 1.0)
    if writes_per_block_s <= 0:
        return float("inf")
    seconds = LEVELING_EFFICIENCY * m.endurance / writes_per_block_s
    return seconds / SECONDS_PER_YEAR
