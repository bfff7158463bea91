"""The overlapped memos pass under faults, its reports, and the engine
serving with ``overlap_plan`` — the port against the JAX package.

* the plan-fault cases of ``tests/test_faults.py``: an injected worker
  exception falls back to a synchronous pass and the breaker climbs
  back to overlap; a hang trips the watchdog; plan and migration faults
  together walk the ladder down to memos-off — pass for pass as the JAX
  manager does;
* ``MemosReport.to_dict`` / ``from_dict`` / ``flat_metrics`` and
  ``aggregate_reports``, the cases of ``tests/test_obs.py``, against the
  JAX reports of the same run (timings excepted), and the worker's
  ``memos.plan`` span on its own ``memos-plan`` thread;
* the paged engine with ``overlap_plan=True`` against the JAX overlap
  engine on numpy-host stores (two tiers and three): tokens, every
  report's page counts, the page table, traffic and wear, also with a
  planned page dirtied mid-plan at every pass; and the port's pinned
  overlap run against its own synchronous pinned run (the JAX pinned
  pool aborts on this CPU, ROADMAP C1).

Watchdog cases trip a 0.2 s timeout with a 1 s delay: a hung worker
keeps its thread until the delay ends.
"""
import json
import threading
import time

import jax
import numpy as np
import pytest

from helpers.memos_pair import (SIDES, alloc_state, collect, drive,
                                record4, report_state)
from helpers.torch_parity import assert_same, cap_threads
from repro import faults as jfaults
from repro import obs as jobs
from repro.configs import registry as jregistry
from repro.configs import smoke as jsmoke
from repro.core import hierarchy as jhierarchy
from repro.core.memos import aggregate_reports as jaggregate_reports
from repro.models import transformer as JT
from repro.serving import PagedServingEngine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch import faults, obs
from repro_torch.configs.base import registry, smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import memos as memos_mod
from repro_torch.core.hierarchy import MemoryHierarchy
from repro_torch.core.memos import MemosReport, aggregate_reports
from repro_torch.faults import RUNG_OFF, RUNG_OVERLAP, RUNG_SYNC
from repro_torch.serving.engine import PagedServingEngine, ServeConfig

cap_threads()

TORCH, JAX = SIDES
TIMING = ("plan_ms", "overlap_efficiency")


@pytest.fixture(autouse=True)
def _clean_global_state():
    for m in (faults, obs, jfaults, jobs):
        m.reset()
    yield
    for m in (faults, obs, jfaults, jobs):
        m.reset()


def _arm(side, **kw):
    """Arm the side's global injector (before its store is built: the
    store latches page integrity)."""
    mod = faults if side.pkg == "torch" else jfaults
    mod.configure(mod.FaultConfig(**kw))


def _mgr(side, store, **kw):
    return side.manager(store, interval=4, adaptive_interval=False,
                        async_plan=True,
                        plan_timeout_s=kw.pop("plan_timeout_s", 5.0),
                        recovery_passes=kw.pop("recovery", 2), **kw)


# =============================================================================
# plan faults: watchdog fallback and the ladder
# =============================================================================

def test_injected_plan_exception_falls_back_and_breaker_repromotes():
    runs = {}
    for side in SIDES:
        _arm(side, seed=13)
        store = side.store(13)
        _arm(side, seed=13, plan_exception_rate=1.0)
        mgr = _mgr(side, store)
        rng = np.random.RandomState(7)
        sm = mgr.begin_pass(record4(side, side.sm_init(store), rng))
        rep = mgr.commit_pending()
        assert rep.fault_fallback == "InjectedPlanFault"
        assert not rep.committed_async and mgr._ticket is None
        assert mgr.ladder.rung == RUNG_SYNC
        _arm(side, seed=13)                        # the storm is over
        for _ in range(2):
            sm, r = mgr.maybe_step(record4(side, sm, rng), steps=4)
            assert r is None or not r.committed_async
        assert mgr.ladder.rung == RUNG_OVERLAP
        sm, _ = mgr.maybe_step(record4(side, sm, rng), steps=4)
        assert mgr._ticket is not None
        rep = mgr.flush()
        assert rep.committed_async and rep.fault_fallback is None
        mgr.close()
        runs[side.pkg] = (collect(store, mgr), mgr.ladder.failures,
                          (faults if side.pkg == "torch"
                           else jfaults).get_injector().counts)
    t, j = runs["torch"], runs["jax"]
    assert t[1] == j[1] == ["plan:InjectedPlanFault"]
    for key in ("reports", "alloc", "traffic", "pages_committed"):
        assert t[0][key] == j[0][key], key
    for key in ("tier", "slot", "version", "pages"):
        assert_same(t[0][key], j[0][key])
    assert obs.get_registry().counter(
        "faults.recovered_plan_fallback").value == 1


def test_plan_hang_trips_watchdog_timeout():
    """A plan delayed past ``plan_timeout_s`` is abandoned: the pass runs
    synchronously ("timeout"), the executor is dropped, the ladder
    demotes — and the fallback's result equals the JAX one's."""
    reps = {}
    for side in SIDES:
        _arm(side, seed=14)
        store = side.store(14)
        _arm(side, seed=14, plan_delay_rate=1.0, plan_delay_s=1.0)
        mgr = _mgr(side, store, plan_timeout_s=0.2)
        sm = record4(side, side.sm_init(store), np.random.RandomState(7))
        mgr.begin_pass(sm)
        t0 = time.monotonic()
        rep = mgr.commit_pending()
        assert time.monotonic() - t0 < 0.9, "the watchdog did not fire"
        assert rep.fault_fallback == "timeout"
        assert mgr.ladder.rung == RUNG_SYNC and mgr._executor is None
        mgr.close()
        reps[side.pkg] = (report_state(rep), store.tier.copy(),
                          store.slot.copy())
    assert reps["torch"][0] == reps["jax"][0]
    assert_same(reps["torch"][1], reps["jax"][1])
    assert_same(reps["torch"][2], reps["jax"][2])


def test_repeated_failures_walk_ladder_to_memos_off():
    """Plan exceptions and migration faults at rate 1: overlap -> sync
    (the plan) -> memos-off (the migrations), rung for rung with JAX."""
    rungs = {}
    for side in SIDES:
        _arm(side, seed=15)
        store = side.store(15)
        _arm(side, seed=15, plan_exception_rate=1.0, migrate_fail_rate=1.0)
        mgr = _mgr(side, store)
        mgr.engine.retry_backoff_s = 1e-6
        sm = side.sm_init(store)
        rng = np.random.RandomState(7)
        got = []
        for _ in range(4):
            sm, _ = mgr.maybe_step(record4(side, sm, rng), steps=4)
            mgr.flush()
            got.append(mgr.ladder.rung)
        assert got[0] == RUNG_SYNC and RUNG_OFF in got
        assert mgr.ladder.demotions >= 2
        mgr.close()
        rungs[side.pkg] = (got, mgr.ladder.failures,
                           [report_state(r) for r in mgr.reports],
                           store.tier.copy(), store.slot.copy())
    t, j = rungs["torch"], rungs["jax"]
    assert t[:3] == j[:3]
    assert_same(t[3], j[3])
    assert_same(t[4], j[4])


# =============================================================================
# reports: serialization, aggregation, the worker's span
# =============================================================================

def _drive_pair(async_plan):
    out = {}
    for side in SIDES:
        store = side.store()
        mgr = side.manager(store, interval=4, adaptive_interval=False,
                           async_plan=async_plan)
        drive(side, mgr)
        mgr.close()
        out[side.pkg] = mgr
    return out["torch"], out["jax"]


def _untimed(d: dict) -> dict:
    return {k: v for k, v in d.items() if k not in TIMING}


@pytest.mark.parametrize("async_plan", [False, True])
def test_memos_report_roundtrip_matches_jax(async_plan):
    """Every report is JSON-safe, round-trips through ``from_dict``, and
    its ``to_dict`` and ``flat_metrics`` equal the JAX report's (the
    plan's wall time and overlap share excepted)."""
    mgr, jmgr = _drive_pair(async_plan)
    assert mgr.reports and any(r.migrations.migrated for r in mgr.reports)
    assert len(mgr.reports) == len(jmgr.reports)
    for rep, jrep in zip(mgr.reports, jmgr.reports):
        d = rep.to_dict()
        back = MemosReport.from_dict(json.loads(json.dumps(d)))
        assert back == rep and back.to_dict() == d
        assert list(d) == list(jrep.to_dict())
        assert _untimed(d) == _untimed(jrep.to_dict())
        flat, jflat = rep.flat_metrics(), jrep.flat_metrics()
        assert set(flat) == set(jflat)
        assert _untimed(flat) == _untimed(jflat)
        assert flat["tier0_pages"] == rep.tier_pages[0]
        assert rep.committed_async == async_plan
        assert (rep.overlap_efficiency is None) == (not async_plan)


@pytest.mark.parametrize("async_plan", [False, True])
def test_aggregate_reports_matches_jax(async_plan):
    mgr, jmgr = _drive_pair(async_plan)
    agg, jagg = aggregate_reports(mgr.reports), \
        jaggregate_reports(jmgr.reports)
    assert set(agg) == set(jagg)
    assert {k: v for k, v in agg.items() if k != "overlap_efficiency_mean"} \
        == {k: v for k, v in jagg.items() if k != "overlap_efficiency_mean"}
    assert agg["passes"] == len(mgr.reports)
    assert agg["migrated"] == sum(r.migrations.migrated for r in mgr.reports)
    assert aggregate_reports([])["passes"] == 0


def test_plan_span_on_the_worker_thread(monkeypatch):
    """A slowed plan runs on the ``memos-plan`` thread, overlaps the main
    thread's dispatch span, and is mostly hidden under it."""
    obs.configure(trace=True)
    store = TORCH.store()
    mgr = TORCH.manager(store, interval=4, adaptive_interval=False,
                        async_plan=True)
    orig = memos_mod.plan
    monkeypatch.setattr(memos_mod, "plan", lambda *a, **k: (
        time.sleep(0.05), orig(*a, **k))[1])
    sm = TORCH.record(TORCH.sm_init(store), np.arange(6), True)
    mgr.begin_pass(sm)
    with obs.span("serve.dispatch", k=16):
        time.sleep(0.08)
    rep = mgr.commit_pending()
    mgr.close()
    ev = {e.name: e for e in obs.get_tracer().events()}
    plan, disp, commit = ev["memos.plan"], ev["serve.dispatch"], \
        ev["memos.commit"]
    main = threading.get_ident()
    assert disp.tid == commit.tid == ev["memos.snapshot"].tid == main
    assert plan.tid != main
    assert obs.get_tracer().thread_names[plan.tid].startswith("memos-plan")
    assert plan.ts_ns < disp.ts_ns + disp.dur_ns
    assert plan.ts_ns + plan.dur_ns > disp.ts_ns
    assert rep.committed_async and rep.overlap_efficiency > 0.5
    assert rep.plan_ms >= 50.0
    assert mgr.overlap_efficiency == pytest.approx(rep.overlap_efficiency)
    flat = obs.get_registry().flat()
    assert flat["memos.pages_committed"] == rep.pages_committed


# =============================================================================
# the engine with overlap_plan
# =============================================================================

SEED = 0
SCFG = dict(page_size=8, max_batch=3, fast_slots=8, slow_slots=128,
            memos_interval=8, decode_block=8)


@pytest.fixture(scope="module")
def models():
    tcfg = smoke(registry()["qwen3_4b"])
    jcfg = jsmoke(jregistry()["qwen3_4b"])
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(SEED))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return tcfg, tparams, jcfg, jparams


def _prompts(vocab):
    rng = np.random.RandomState(SEED)
    return [rng.randint(0, vocab, size=n).tolist() for n in (5, 3, 9, 6)]


def _hook(dirtied):
    def dirty_first(mgr, decision, plans):
        for pl in plans:
            if len(pl):
                mgr.store.bump_version(int(pl.pages[0]))
                dirtied.append(int(pl.pages[0]))
                return
    return dirty_first


def _serve(eng, prompts, hook=None):
    if hook is not None:
        eng.memos._mid_plan_hook = hook
    reqs = [eng.submit(p, 16) for p in prompts]
    hist = eng.run(max_steps=600)
    eng.close()
    assert eng.batcher.all_done()
    return reqs, hist


def _assert_engines_match(teng, treqs, thist, jeng, jreqs, jhist):
    for t, j in zip(treqs, jreqs):
        assert (t.generated, t.tokens, t.error) == \
            (j.generated, j.tokens, j.error)
    # the boundary stats: the same keys, power_mw (a float from the
    # energy model) within 1e-12
    tm = [h.get("memos") for h in thist]
    jm = [h.get("memos") for h in jhist]
    assert [m is None for m in tm] == [m is None for m in jm]
    for a, b in zip(tm, jm):
        if a is not None:
            assert list(a) == list(b)
            assert {k: v for k, v in a.items() if k != "power_mw"} == \
                {k: v for k, v in b.items() if k != "power_mw"}
            assert a["power_mw"] == pytest.approx(b["power_mw"], rel=1e-12)
    ts, js = teng.kv.store, jeng.kv.store
    for f in ("tier", "slot", "version"):
        assert_same(getattr(ts, f), getattr(js, f))
    assert ts.traffic == js.traffic
    assert (ts.writes_to, ts.reads_from) == (js.writes_to, js.reads_from)
    assert [alloc_state(a) for a in ts.alloc] == \
        [alloc_state(a) for a in js.alloc]
    assert len(teng.memos.reports) == len(jeng.memos.reports) > 0
    for t, j in zip(teng.memos.reports, jeng.memos.reports):
        assert report_state(t) == report_state(j)
    for k in ("pages_committed", "pages_degraded", "pages_dropped"):
        assert getattr(teng.memos, k) == getattr(jeng.memos, k)
    for t in ts.wear_by_tier:
        assert_same(ts.wear_by_tier[t].wear_counts(),
                    js.wear_by_tier[t].wear_counts())
        assert ts.wear_by_tier[t].writes_total == \
            js.wear_by_tier[t].writes_total


@pytest.mark.parametrize("three_tier", [False, True])
def test_overlap_engine_matches_jax(models, three_tier):
    """The overlapped engine against the JAX one on numpy-host stores:
    identical tokens, every report's page counts, page table, traffic,
    allocators and wear; every pass commits asynchronously; and the
    port's own synchronous run gives the same tokens."""
    tcfg, tparams, jcfg, jparams = models
    prompts = _prompts(tcfg.vocab)
    kw = dict(SCFG, overlap_plan=True)
    jkw = dict(kw)
    if three_tier:
        kw["hierarchy"] = MemoryHierarchy.three_tier(8, 4, 128)
        jkw["hierarchy"] = jhierarchy.MemoryHierarchy.three_tier(8, 4, 128)
    teng = PagedServingEngine(tcfg, tparams, ServeConfig(**kw),
                              device="cpu")
    jeng = JEngine(jcfg, jparams, JServeConfig(**jkw))
    treqs, thist = _serve(teng, prompts)
    jreqs, jhist = _serve(jeng, prompts)
    _assert_engines_match(teng, treqs, thist, jeng, jreqs, jhist)
    assert all(r.committed_async for r in teng.memos.reports)
    assert teng.memos.pages_committed > 0
    ts = teng.kv.store
    assert sum(ts.traffic.values()) > 0
    if three_tier:
        assert ts.traffic[(0, 1)] + ts.traffic[(1, 0)] > 0
    sync = PagedServingEngine(tcfg, tparams, ServeConfig(
        **{**kw, "overlap_plan": False}), device="cpu")
    sreqs, _ = _serve(sync, prompts)
    assert [r.generated for r in sreqs] == [r.generated for r in treqs]
    assert_same(sync.sysmon.hist, teng.sysmon.hist)


def test_overlap_engine_forced_mid_plan_dirtying_matches_jax(models):
    """A planned page dirtied mid-plan at every pass: each degrades, the
    rest still commits, serving stays lossless — the same in both
    packages."""
    tcfg, tparams, jcfg, jparams = models
    prompts = _prompts(tcfg.vocab)
    tdirt, jdirt = [], []
    teng = PagedServingEngine(tcfg, tparams, ServeConfig(
        **SCFG, overlap_plan=True), device="cpu")
    jeng = JEngine(jcfg, jparams, JServeConfig(**SCFG, overlap_plan=True))
    treqs, thist = _serve(teng, prompts, _hook(tdirt))
    jreqs, jhist = _serve(jeng, prompts, _hook(jdirt))
    assert tdirt == jdirt and tdirt
    _assert_engines_match(teng, treqs, thist, jeng, jreqs, jhist)
    assert teng.memos.pages_degraded >= len(tdirt)
    assert teng.memos.pages_committed > 0
    assert sum(r.plan_conflict for r in teng.memos.reports) == len(tdirt)


def test_pinned_overlap_engine_matches_its_sync_run(models):
    """Over a pinned-host NVM tier served in place: the overlapped
    engine emits the synchronous engine's tokens and closes SysMon
    passes at the same boundaries, commits every pass asynchronously,
    and demotes pages into the pinned tier, which serves them in place
    (no promotion back)."""
    tcfg, tparams, _, _ = models
    prompts = _prompts(tcfg.vocab)
    runs = {}
    for overlap in (False, True):
        eng = PagedServingEngine(tcfg, tparams, ServeConfig(
            **{**SCFG, "fast_slots": 4}, overlap_plan=overlap,
            hierarchy=MemoryHierarchy.two_tier(4, 128, pinned_slow=True)),
            device="cpu")
        reqs, _ = _serve(eng, prompts)
        runs[overlap] = (eng, reqs)
    (s, sreqs), (o, oreqs) = runs[False], runs[True]
    assert [r.generated for r in oreqs] == [r.generated for r in sreqs]
    assert len(o.memos.reports) == len(s.memos.reports) > 0
    assert_same(o.sysmon.hist, s.sysmon.hist)
    assert all(r.committed_async for r in o.memos.reports)
    assert o.memos.pages_committed > 0
    st = o.kv.store
    assert st.traffic[(0, 1)] > 0 and st.reads_from[1] > 0
    assert st.wear_by_tier[1].writes_total > 0
