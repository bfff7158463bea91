"""memos core — the paper's contribution as a torch/numpy library.

Modules:
  patterns   — WD/RD/hotness/reuse classification (Sec. 3.1, 3.3)
  predictor  — write-history window prediction + Reverse rule (Sec. 3.2)
  sysmon     — on-device profiling counters + pass harvesting (Sec. 4.2)
  allocator  — color-indexed sub-buddy allocator (Sec. 6.2)
  hierarchy  — MediumSpec / MemoryHierarchy N-tier description (Sec. 1)
  placement  — channel policy, hotness list, Algorithm 2 (Sec. 5.2/5.3)
  migration  — locked + optimistic migration (Sec. 6.3)
  tiers      — N-tier hybrid page store (MCHA analogue, Sec. 5.1)
  memos      — the periodic management loop (Fig. 10)
  costmodel  — Table-1 latency/energy/lifetime model (Sec. 7.1)
"""
from . import (allocator, costmodel, hierarchy, memos, migration, patterns,
               placement, predictor, sysmon, tiers)
from .hierarchy import MediumSpec, MemoryHierarchy
from .memos import MemosConfig, MemosManager
from .tiers import StoreConfig, TierConfig, TierStore

__all__ = [
    "allocator", "costmodel", "hierarchy", "memos", "migration", "patterns",
    "placement", "predictor", "sysmon", "tiers", "MediumSpec",
    "MemoryHierarchy", "MemosConfig", "MemosManager", "StoreConfig",
    "TierConfig", "TierStore",
]
