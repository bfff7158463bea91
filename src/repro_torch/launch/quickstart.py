"""Quickstart: the memos core on a synthetic page workload (torch twin of
``examples/quickstart.py``, with the same printed lines).

Builds a hybrid fast/slow ``TierStore``, drives a phased access pattern
through SysMon, and shows the memos loop (predict -> plan -> migrate)
moving hot/WD pages to the fast tier and draining cold pages to the slow
tier, with page contents checked bit-exact at the end:

    PYTHONPATH=src python -m repro_torch.launch.quickstart               # the card
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import sysmon
from repro_torch.core.hierarchy import SLOW
from repro_torch.core.memos import MemosConfig, MemosManager
from repro_torch.core.tiers import TierConfig, TierStore
from repro_torch.device import resolve_device

N_PAGES, FAST_SLOTS = 64, 16


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    store = TierStore(TierConfig(n_pages=N_PAGES, fast_slots=FAST_SLOTS,
                                 slow_slots=N_PAGES, page_shape=(8,)),
                      device=device)
    for p in range(N_PAGES):
        store.allocate(p, SLOW)                   # everything starts "on NVM"
        store.write_page(p, np.full(8, p, np.float32))

    mgr = MemosManager(store, MemosConfig(interval=4,
                                          adaptive_interval=False))
    sm = sysmon.init(N_PAGES, n_banks=8, n_slabs=4, device=device)

    print(f"{'step':>4} {'fast':>5} {'slow':>5} {'migrated':>9} "
          f"{'imbalance':>9}")
    warm = torch.arange(40, 48, device=device)   # read-mostly pages
    for step in range(48):
        phase = step // 16                        # working set shifts twice
        hot = torch.arange(phase * 8, phase * 8 + 8, device=device)
        sm = sysmon.record(sm, hot, is_write=True)
        sm = sysmon.record(sm, warm, is_write=False)
        sm, report = mgr.maybe_step(sm)
        if report:
            print(f"{step:>4} {report.fast_pages:>5} {report.slow_pages:>5} "
                  f"{report.migrations.migrated:>9} "
                  f"{report.bank_imbalance:>9.2f}")

    tiers = np.asarray(store.tier)
    print("\nfinal placement (phase-2 hot pages 16..23 should be FAST):")
    print("  pages 16..23 tier:", tiers[16:24].tolist(), "(0=FAST)")
    print("  pages  0..7  tier:", tiers[0:8].tolist(), "(1=SLOW, decayed)")
    for p in range(N_PAGES):                      # contents always intact
        np.testing.assert_array_equal(store.read_page(p), np.full(8, p))
    print("all page contents bit-exact after migrations ✓")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
