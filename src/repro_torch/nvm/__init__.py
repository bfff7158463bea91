"""NVM wear & energy telemetry (paper Sec. 7.1, Table 1) — the torch twin
of ``repro.nvm``: per-physical-slot wear counters fed by the
``wear_update`` kernel, Start-Gap leveling, and per-pass energy /
lifetime accounting."""
from .energy import EnergyMeter, NvmReport
from .leveling import LevelingStats, StartGapLeveler
from .wear import NvmWear, WearState, init_wear, record_writes

__all__ = ["NvmWear", "WearState", "init_wear", "record_writes",
           "LevelingStats",
           "StartGapLeveler", "EnergyMeter", "NvmReport"]
