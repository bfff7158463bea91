"""The port's asynchronous memos pass against the JAX package's.

Twins of ``tests/test_async_memos.py``: every case runs on the same
seeded two-tier store in both packages (``helpers/memos_pair.py``) and
compares page tables, versions, pool bytes, wear, allocator bookkeeping,
the plans and every report's page counts exactly.  Within the port the
overlapped pass must also equal its own synchronous pass when nothing
interferes.  The snapshot and the ticket the worker plans from must
hold no tensor: a CUDA op from the worker thread would synchronise with
the dispatch it is meant to overlap.
"""
import dataclasses
import sys
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from helpers.memos_pair import (SIDES, Side, alloc_state, assert_same_state,
                                collect, drive, plan_state, record4,
                                report_state)
from helpers.torch_parity import cap_threads
from repro.core import migration as jmigration
from repro_torch.core import migration as tmigration
from repro_torch.core.tiers import NO_SLOT
from repro_torch.faults import RUNG_OVERLAP, RUNG_SYNC

cap_threads()

TORCH, JAX = SIDES


def cfg(async_plan, **kw):
    return dict(interval=4, adaptive_interval=False, async_plan=async_plan,
                **kw)


def assert_consistent(store):
    for t in range(store.n_tiers):
        store.alloc[t].check_consistency()
    live = store.slot != NO_SLOT
    for t in np.unique(store.tier[live]):
        ss = store.slot[live][store.tier[live] == t]
        assert len(set(ss.tolist())) == ss.size, "slot double-booked"


def run_drive(side, async_plan, hook=None):
    store = side.store()
    mgr = side.manager(store, **cfg(async_plan))
    drive(side, mgr, mid_plan_hook=hook)
    mgr.close()
    return store, mgr


def test_clean_commit_bit_identical_to_sync_and_jax():
    """No mid-plan interference: every port pass commits through the
    overlapped path, its state equals the port's synchronous run bit for
    bit, and both equal the JAX overlapped run."""
    runs = {}
    for side in SIDES:
        for a in (False, True):
            store, mgr = run_drive(side, a)
            runs[side.pkg, a] = (store, mgr, collect(store, mgr))
    tstore, tmgr, tstate = runs["torch", True]
    assert tmgr.pages_committed > 0 and tmgr.pages_degraded == 0
    assert all(r.committed_async for r in tmgr.reports)
    assert any(r.migrations.migrated for r in tmgr.reports)
    assert not any(r.plan_conflict for r in tmgr.reports)
    assert_same_state(tstate, runs["jax", True][2], "torch vs jax async: ")
    sync = runs["torch", False][2]
    for key in ("tier", "slot", "version", "fast_pool", "slow_pool", "wear",
                "remap", "writes_total", "leveling", "pages", "traffic"):
        assert_same_state({key: tstate[key]}, {key: sync[key]},
                          "async vs sync: ")
    assert [(r["migrations"], r["n_marked"]) for r in tstate["reports"]] == \
        [(r["migrations"], r["n_marked"]) for r in sync["reports"]]
    assert_consistent(tstore)


def one_pass(side: Side, async_plan, hook=None):
    """Two explicit passes over a fixed access pattern; the second (the
    one that migrates) gets ``hook`` installed just before its commit.
    Returns (store, manager, the second pass's report)."""
    store = side.store()
    mgr = side.manager(store, **cfg(async_plan))
    sm = side.sm_init(store)
    rng = np.random.RandomState(7)
    sm = record4(side, sm, rng)
    if async_plan:
        sm = mgr.begin_pass(sm)
        mgr.commit_pending()
        sm = record4(side, sm, rng)
        sm = mgr.begin_pass(sm)
        mgr._mid_plan_hook = hook
        rep = mgr.commit_pending()
    else:
        sm, _ = mgr.run_pass(sm)
        sm = record4(side, sm, rng)
        sm, rep = mgr.run_pass(sm)
    mgr.close()
    return store, mgr, rep


def _hooked_pair(make_hook):
    """``one_pass`` with a fresh hook on each side; returns per side
    (store, manager, report, what the hook saw)."""
    out = {}
    for side in SIDES:
        seen = {}
        store, mgr, rep = one_pass(side, True, make_hook(seen))
        out[side.pkg] = (store, mgr, rep, seen)
    t, j = out["torch"], out["jax"]
    assert t[3]["plans"] == j[3]["plans"], "plans differ from JAX's"
    assert report_state(t[2]) == report_state(j[2])
    assert_same_state(collect(t[0], t[1]), collect(j[0], j[1]))
    return out


def test_single_page_dirtying_commits_remainder():
    """One planned page dirtied mid-plan degrades alone; every other
    planned page lands where the synchronous pass puts it — in both
    packages, with the same plans and reports."""
    def make_hook(seen):
        def dirty_one(m, decision, plans):
            pl = next(p for p in plans if len(p))
            seen["page"] = int(pl.pages[0])
            seen["where"] = (int(m.store.tier[seen["page"]]),
                             int(m.store.slot[seen["page"]]))
            seen["plans"] = plan_state(plans)
            m.store.bump_version(seen["page"])
        return dirty_one

    out = _hooked_pair(make_hook)
    store, mgr, rep, seen = out["torch"]
    sstore, _, _ = one_pass(TORCH, False)
    p = seen["page"]
    planned = [q for pl in seen["plans"] for q in pl["pages"]]
    assert rep.committed_async and rep.plan_conflict
    assert rep.pages_degraded == 1
    assert rep.pages_committed == len(planned) - 1
    assert (int(store.tier[p]), int(store.slot[p])) == seen["where"]
    for q in planned:
        if q != p:
            assert (int(store.tier[q]), int(store.slot[q])) == \
                (int(sstore.tier[q]), int(sstore.slot[q]))
    assert_consistent(store)


def test_freed_mid_plan_page_drops_without_conflict():
    def make_hook(seen):
        def free_one(m, decision, plans):
            pl = next(p for p in plans if len(p))
            seen["page"] = int(pl.pages[0])
            seen["plans"] = plan_state(plans)
            m.store.release(seen["page"])
        return free_one

    out = _hooked_pair(make_hook)
    store, mgr, rep, seen = out["torch"]
    planned = [q for pl in seen["plans"] for q in pl["pages"]]
    assert rep.committed_async and rep.pages_dropped == 1
    assert rep.pages_degraded == 0 and not rep.plan_conflict
    assert rep.pages_committed == len(planned) - 1
    assert int(store.slot[seen["page"]]) == NO_SLOT
    assert_consistent(store)


def test_forced_mid_plan_dirtying_every_pass():
    """Every pass gets its first planned page dirtied mid-plan: each
    commit degrades exactly that page and commits the rest; the port's
    run equals the JAX run."""
    states, bumped = {}, {}
    for side in SIDES:
        b = bumped[side.pkg] = {}

        def dirty_first(mgr, decision, plans, b=b):
            for pl in plans:
                if len(pl):
                    b[len(mgr.reports)] = int(pl.pages[0])
                    mgr.store.bump_version(int(pl.pages[0]))
                    return

        store, mgr = run_drive(side, True, dirty_first)
        states[side.pkg] = (store, mgr, collect(store, mgr))
    assert bumped["torch"] == bumped["jax"] and bumped["torch"]
    assert_same_state(states["torch"][2], states["jax"][2])
    store, mgr, _ = states["torch"]
    assert mgr.pages_degraded == len(bumped["torch"])
    conflicted = [r for r in mgr.reports if r.plan_conflict]
    assert len(conflicted) == len(bumped["torch"])
    assert all(r.pages_degraded == 1 for r in conflicted)
    assert any(r.pages_committed > 0 for r in conflicted)
    assert_consistent(store)


def test_replay_divergence_commits_alternate_slots():
    """A slot stolen from the plan's destination tier mid-plan makes the
    commit replay its calls onto other slots; nothing degrades, no page
    lands on the stolen slot, and both packages agree."""
    states, stolen = {}, {}
    for side in SIDES:
        s = stolen[side.pkg] = []

        def steal(m, decision, plans, s=s):
            if s:
                return
            for pl in plans:
                if len(pl):
                    got = m.store.alloc[pl.dst_tier].alloc(0, None)
                    if got is not None:
                        s.append((pl.dst_tier, got))
                    return

        store, mgr = run_drive(side, True, steal)
        states[side.pkg] = (store, mgr, collect(store, mgr))
    assert stolen["torch"] == stolen["jax"] and stolen["torch"]
    assert_same_state(states["torch"][2], states["jax"][2])
    store, mgr, _ = states["torch"]
    assert mgr.pages_degraded == 0 and mgr.pages_committed > 0
    live = store.slot != NO_SLOT
    for t, s in stolen["torch"]:
        assert not ((store.tier[live] == t) & (store.slot[live] == s)).any()
    assert_consistent(store)


@pytest.mark.parametrize("interfere", [False, True])
def test_commit_reservations_exactness(interfere):
    """A plan simulated on a StoreView lands on the live store: clone
    adoption with the simulated slots on a quiet tier, a replay patched
    around an interloper's slot otherwise — the same in both packages."""
    got = {}
    for side, mig in ((TORCH, tmigration), (JAX, jmigration)):
        store = side.store()
        view = mig.StoreView(store)
        plan = mig.plan_locked(view, range(6), 0, bank_freq=np.ones(2),
                               slab_freq=np.ones(4))
        planned = plan.dst_slots.copy()
        n_free = store.alloc[0].n_free
        thief = None
        if interfere:
            c, m = int(plan.colors[0]), int(plan.masks[0])
            thief = store.alloc[0].alloc(0, None if c < 0 else c,
                                         None if m < 0 else m)
            assert thief == int(planned[0])
        (ok,) = mig.commit_reservations(store, view, [plan])
        assert ok.all()
        slots = plan.dst_slots.tolist()
        if interfere:
            assert thief not in slots and len(set(slots)) == len(slots)
            assert store.alloc[0].n_free == n_free - 7
        else:
            assert slots == planned.tolist()
            assert store.alloc[0].n_free == n_free - 6
        assert store.end_dirty_epoch() == set()
        store.alloc[0].check_consistency()
        got[side.pkg] = (slots, alloc_state(store.alloc[0]),
                         store.alloc[0] is view.alloc[0])
    assert got["torch"] == got["jax"]
    assert got["torch"][2] is (not interfere)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_dirty_epoch_never_misses_a_change(seed):
    """Over a random stream of writes, version bumps, dispatch charges,
    moves and alloc/release, the epoch's dirty set holds every external
    write and placement change, never a page only charged by a dispatch,
    and equals the JAX store's set for the same stream."""
    sets = {}
    for side in SIDES:
        store = side.store(seed)
        rng = np.random.RandomState(100 + seed)
        mig = tmigration if side.pkg == "torch" else jmigration
        view = mig.StoreView(store)
        external, charged = set(), np.zeros(32, np.int64)
        for _ in range(60):
            op, p = rng.randint(5), int(rng.randint(32))
            if op == 0:
                if int(store.slot[p]) != NO_SLOT:
                    store.write_page(
                        p, rng.standard_normal(4).astype(np.float32))
                    external.add(p)
            elif op == 1:
                store.bump_version(p)
                external.add(p)
            elif op == 2:
                pw = np.zeros(32, np.int64)
                pw[rng.randint(0, 32, size=3)] += 1
                store.charge_fast_accesses(pw, n_reads=4)
                charged += pw
            elif op == 3:
                if int(store.slot[p]) != NO_SLOT:
                    dst = int(rng.randint(store.n_tiers))
                    if int(store.tier[p]) != dst:
                        store.move_page(p, dst)
            elif int(store.slot[p]) != NO_SLOT:
                store.release(p)
            else:
                store.allocate(p, int(rng.randint(store.n_tiers)))
        dirty = store.end_dirty_epoch()
        moved = set(np.nonzero((store.tier != view.tier)
                               | (store.slot != view.slot))[0].tolist())
        assert not (external | moved) - dirty
        only_charged = set(np.nonzero(charged)[0].tolist()) - external \
            - moved
        assert not only_charged & dirty
        sets[side.pkg] = (dirty, store.tier.copy(), store.slot.copy(),
                          store.version.copy())
    t, j = sets["torch"], sets["jax"]
    assert t[0] == j[0]
    for a, b in zip(t[1:], j[1:]):
        np.testing.assert_array_equal(a, b)


def _walk(obj, seen=None):
    """Every object reachable from ``obj`` through dataclass fields,
    tuples, lists, dicts and instance attributes."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    yield obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        kids = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    elif isinstance(obj, (list, tuple, set, frozenset)):
        kids = list(obj)
    elif isinstance(obj, dict):
        kids = list(obj.keys()) + list(obj.values())
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        kids = list(vars(obj).values())
    else:
        kids = []
    for k in kids:
        yield from _walk(k, seen)


def test_snapshot_and_ticket_hold_no_tensor():
    """The ticket the worker plans from — the numpy summary, the
    StoreView and its cloned allocators — holds no torch tensor, and the
    plan the worker returns holds none either."""
    store = TORCH.store()
    mgr = TORCH.manager(store, **cfg(True))
    sm = record4(TORCH, TORCH.sm_init(store), np.random.RandomState(7))
    assert isinstance(sm.reads, torch.Tensor)
    mgr.begin_pass(sm)
    t = mgr._ticket
    decision, plans, spill = t.future.result(timeout=30)
    fields = {f.name for f in dataclasses.fields(t)} - {"future"}
    for name in fields:
        for obj in _walk(getattr(t, name)):
            assert not isinstance(obj, torch.Tensor), \
                f"ticket.{name} holds a tensor"
    assert all(isinstance(x, np.ndarray) for x in t.summary)
    for obj in _walk((decision, plans, spill)):
        assert not isinstance(obj, torch.Tensor), "the plan holds a tensor"
    assert mgr.commit_pending().committed_async
    mgr.close()


def test_store_churn_while_the_worker_plans():
    """The main thread allocates, releases and writes pages while the
    worker plans (thread switches every microsecond): no page touched
    mid-plan is moved by the commit, every other planned page commits,
    and the allocators stay consistent."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        store = TORCH.store()
        mgr = TORCH.manager(store, **cfg(True))
        rng = np.random.RandomState(3)
        sm = TORCH.sm_init(store)
        committed = 0
        for _ in range(12):
            sm = mgr.begin_pass(record4(TORCH, sm, rng))
            touched = set()
            for i in range(400):
                if i >= 40 and mgr._ticket.future.done():
                    break
                p, op = int(rng.randint(32)), rng.randint(3)
                if op == 0 and int(store.slot[p]) != NO_SLOT:
                    store.release(p)
                elif op == 0:
                    store.allocate(p, 1)
                elif int(store.slot[p]) != NO_SLOT:
                    store.write_page(p, np.full(4, float(i), np.float32))
                else:
                    continue
                touched.add(p)
            where = {p: (int(store.tier[p]), int(store.slot[p]))
                     for p in touched}
            rep = mgr.commit_pending()
            assert rep.committed_async
            committed += rep.pages_committed
            for p, w in where.items():
                assert (int(store.tier[p]), int(store.slot[p])) == w, \
                    f"page {p} touched mid-plan was moved by the commit"
            assert_consistent(store)
        assert committed > 0
        mgr.close()
    finally:
        sys.setswitchinterval(old)


def test_worker_death_degrades_to_sync_then_reenables_overlap():
    """The plan worker dies mid-flight: the commit falls back to a
    synchronous pass, the ladder drops to sync, two healthy passes bring
    overlap back with a fresh executor — pass for pass as in JAX."""
    trace = {}
    for side in SIDES:
        store = side.store()
        mgr = side.manager(store, recovery_passes=2, **cfg(True))
        rng = np.random.RandomState(7)
        sm = record4(side, side.sm_init(store), rng)
        sm = mgr.begin_pass(sm)
        assert mgr._executor is not None
        mgr._executor.shutdown(wait=True)
        dead = Future()
        dead.set_exception(RuntimeError("plan worker died"))
        mgr._ticket.future = dead
        rep = mgr.commit_pending()
        assert rep.fault_fallback == "RuntimeError"
        assert not rep.committed_async
        assert mgr.ladder.rung == RUNG_SYNC
        assert mgr._executor is None and mgr._ticket is None
        assert store.end_dirty_epoch() == set()
        rungs = []
        for _ in range(2):
            sm = record4(side, sm, rng)
            sm, _ = mgr.maybe_step(sm, steps=4)
            assert mgr._ticket is None
            rungs.append(mgr.ladder.rung)
        assert rungs == [RUNG_SYNC, RUNG_OVERLAP]
        sm = record4(side, sm, rng)
        sm, _ = mgr.maybe_step(sm, steps=4)
        assert mgr._ticket is not None and mgr._executor is not None
        rep = mgr.flush()
        assert rep.committed_async and rep.fault_fallback is None
        assert_consistent(store)
        mgr.close()
        trace[side.pkg] = collect(store, mgr)
    assert_same_state(trace["torch"], trace["jax"])


def passes_after(side, steps_seq, interval=4):
    store = side.store()
    mgr = side.manager(store, interval=interval, adaptive_interval=False)
    sm = side.sm_init(store)
    counts = []
    for k in steps_seq:
        sm = side.record(sm, [0, 1], True)
        sm, _ = mgr.maybe_step(sm, steps=k)
        counts.append(len(mgr.reports))
    return counts


@pytest.mark.parametrize("steps_seq,want", [
    ([8, 1, 1, 2], [1, 2, 2, 3]), ([4, 4, 4], [1, 2, 3]),
    ([2, 2, 2, 2], [0, 1, 1, 2]), ([16, 1, 1, 1], [1, 2, 2, 2])])
def test_interval_accounting(steps_seq, want):
    """A dispatch spanning more than one interval banks its overshoot
    (capped at one interval), in both packages."""
    assert passes_after(TORCH, steps_seq) == want == \
        passes_after(JAX, steps_seq)
