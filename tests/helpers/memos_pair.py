"""One memos scenario driven through both packages (tests/test_torch_*).

``Side("torch")`` and ``Side("jax")`` build the same seeded two-tier
store (32 pages of 4 floats, 8 HBM slots, a numpy host tier with
Start-Gap every 5 writes), the same ``MemosManager`` and the same SysMon
record stream, so a test runs one scenario on each side and compares
``collect()`` exactly: page table, versions, pool bytes, wear, traffic,
allocator bookkeeping and every report's counts.  The JAX store is
always a numpy-host one: its pinned pool aborts on this CPU (ROADMAP
C1).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from helpers.torch_parity import np_of
from repro.core import memos as jmemos
from repro.core import sysmon as jsysmon
from repro.core import tiers as jtiers
from repro_torch.core import memos as tmemos
from repro_torch.core import sysmon as tsysmon
from repro_torch.core import tiers as ttiers

N_PAGES = 32


class Side:
    """The port (``"torch"``, CPU tensors) or the JAX package."""

    def __init__(self, pkg: str):
        assert pkg in ("torch", "jax")
        self.pkg = pkg
        self.memos = tmemos if pkg == "torch" else jmemos

    def store(self, seed: int = 0):
        """A populated two-tier store: every page allocated where it
        starts (the host tier) and written with seeded normals."""
        kw = dict(n_pages=N_PAGES, fast_slots=8, slow_slots=32,
                  page_shape=(4,), n_banks=2, n_slabs=4,
                  gap_write_interval=5)
        if self.pkg == "torch":
            store = ttiers.TierStore(ttiers.TierConfig(
                dtype=torch.float32, **kw), device="cpu")
        else:
            store = jtiers.TierStore(jtiers.TierConfig(dtype=jnp.float32,
                                                       **kw))
        rng = np.random.RandomState(seed)
        for p in range(N_PAGES):
            assert store.allocate(p, int(store.tier[p]))
            store.write_page(p, rng.standard_normal(4).astype(np.float32))
        return store

    def manager(self, store, recovery_passes: int | None = None, **cfg):
        """The side's manager; ``recovery_passes`` sets the circuit
        breaker's count (a config field in JAX, the port's
        ``BREAKER_RECOVERY_PASSES`` constant read by the ladder)."""
        if recovery_passes is not None and self.pkg == "jax":
            cfg["breaker_recovery_passes"] = recovery_passes
        mgr = self.memos.MemosManager(store, self.memos.MemosConfig(**cfg))
        if recovery_passes is not None:
            mgr.ladder.recovery_passes = recovery_passes
        return mgr

    def sm_init(self, store):
        if self.pkg == "torch":
            return tsysmon.init(N_PAGES, store.cfg.n_banks,
                                store.cfg.n_slabs, device="cpu")
        return jsysmon.init(N_PAGES, store.cfg.n_banks, store.cfg.n_slabs)

    def record(self, sm, ids, is_write: bool):
        ids = np.asarray(ids, np.int32)
        if self.pkg == "torch":
            return tsysmon.record(sm, torch.from_numpy(ids),
                                  is_write=is_write)
        return jsysmon.record(sm, jnp.asarray(ids), is_write=is_write)


SIDES = (Side("torch"), Side("jax"))


def drive(side: Side, mgr, n_steps: int = 24, mid_plan_hook=None):
    """The phased hot-set scenario of ``tests/test_async_memos.py``: hot
    pages move every 8 steps, three random warm reads a step, one
    ``maybe_step`` a step, then a flush."""
    if mid_plan_hook is not None:
        mgr._mid_plan_hook = mid_plan_hook
    sm = side.sm_init(mgr.store)
    rng = np.random.RandomState(7)
    for step in range(n_steps):
        phase = step // 8
        sm = side.record(sm, np.arange(phase * 6, phase * 6 + 6), True)
        sm = side.record(sm, rng.randint(20, 32, size=3), False)
        sm, _ = mgr.maybe_step(sm)
    mgr.flush()
    return sm


def record4(side: Side, sm, rng):
    """Four steps of pages 0-5 written and three warm pages read."""
    for _ in range(4):
        sm = side.record(sm, np.arange(6), True)
        sm = side.record(sm, rng.randint(20, 32, size=3), False)
    return sm


def alloc_state(a) -> tuple:
    """A sub-buddy allocator's whole bookkeeping, comparable with ==."""
    return ([{c: list(dq) for c, dq in sorted(b.items())}
             for b in a.free_lists],
            sorted(a._free_blocks), sorted(a._allocated),
            sorted(a._retired), a.n_free, a.gen)


REPORT_FIELDS = ("step", "n_marked", "fast_pages", "slow_pages",
                 "spilled", "tier_pages", "wear_pressure",
                 "committed_async", "plan_conflict", "pages_committed",
                 "pages_degraded", "pages_dropped", "fault_fallback")


def report_state(rep) -> dict:
    """A report's integer and flag fields and its migration stats."""
    out = {f: getattr(rep, f) for f in REPORT_FIELDS}
    out["migrations"] = rep.migrations.to_dict()
    return out


def collect(store, mgr) -> dict:
    """Everything a pass can change, as numpy / plain Python."""
    wear = store.wear
    out = {
        "tier": store.tier.copy(), "slot": store.slot.copy(),
        "version": store.version.copy(),
        "fast_pool": np_of(store.fast_pool).astype(np.float32),
        "slow_pool": np.array(np_of(store.pools[1].data)),
        "wear": np_of(wear.wear_counts()),
        "remap": np.array(wear._remap),
        "writes_total": int(wear.writes_total),
        "leveling": int(wear.leveling_writes),
        "traffic": dict(store.traffic),
        "writes_to": dict(store.writes_to),
        "reads_from": dict(store.reads_from),
        "alloc": [alloc_state(a) for a in store.alloc],
        "reports": [report_state(r) for r in mgr.reports],
        "pages_committed": mgr.pages_committed,
        "pages_degraded": mgr.pages_degraded,
        "pages_dropped": mgr.pages_dropped,
    }
    # released pages read as NaN (they have no slot)
    out["pages"] = np.stack([
        store.read_page(p) if int(store.slot[p]) != -1
        else np.full(4, np.nan, np.float32) for p in range(N_PAGES)])
    return out


def assert_same_state(got: dict, want: dict, what: str = "") -> None:
    assert set(got) == set(want)
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f"{what}{key}")
        else:
            assert g == w, f"{what}{key}: {g} != {w}"


def plan_state(plans) -> list[dict]:
    """MigrationPlans as comparable dicts (arrays as lists)."""
    out = []
    for pl in plans:
        d = {}
        for f in dataclasses.fields(pl):
            v = getattr(pl, f.name)
            d[f.name] = v.tolist() if isinstance(v, np.ndarray) else v
        out.append(d)
    return out
