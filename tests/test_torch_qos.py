"""Multi-tenant QoS in the port against the JAX package's ``repro.qos``
and its engine hooks:

* the tenant classes, ``QoSConfig`` and their validation errors;
* the trace generators, event for event, and the JSONL bytes against
  JAX's writer and the committed ``benchmarks/traces/*.jsonl``;
* ``PowerGovernor`` on the same seeded readings, state for state;
* ``MemosManager`` with a power budget and tenant page weights on one
  seeded store (``tests/helpers/memos_pair.py``), synchronous and
  overlapped: page tables, pool bytes, wear, reports and the governor's
  trajectory exactly, the lazy ``_page_weight`` and the snapshot copy;
* the paged engine at smoke width with ``ServeConfig(qos=...)``, the
  cases of ``tests/test_qos.py``: a bare ``QoSConfig()`` serves as
  ``qos=None``, priorities reorder service, per-tenant histograms
  publish, the power cap narrows admission and recovers, the report
  round trip;
* the first 12 events of ``mixed_overload`` and ``steady_power``
  replayed on the engine's step clock through both engines.

Integer and host state must match exactly; tokens come from float32
greedy decode with the carried JAX weights (``params_from_jax``).  JAX
stores are numpy-host ones: the JAX pinned pool aborts on this CPU
(ROADMAP C1).
"""
from collections import deque
from pathlib import Path

import jax
import numpy as np
import pytest

from helpers.memos_pair import SIDES, assert_same_state, collect, record4
from helpers.torch_parity import assert_close, assert_same, cap_threads
from repro import obs as jobs
from repro import qos as jqos
from repro.configs import registry as jregistry
from repro.configs import smoke as jsmoke
from repro.core.hierarchy import MemoryHierarchy as JHierarchy
from repro.models import transformer as JT
from repro.qos import traces as jtraces
from repro.serving import PagedServingEngine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch import obs, qos
from repro_torch.configs.base import registry, smoke
from repro_torch.convert import params_from_jax
from repro_torch.core.hierarchy import MemoryHierarchy
from repro_torch.core.memos import MemosReport
from repro_torch.qos import traces
from repro_torch.qos.tenants import CLASS_DEFAULTS, DEFAULT_TENANT
from repro_torch.serving.engine import PagedServingEngine, ServeConfig

cap_threads()

ROOT = Path(__file__).resolve().parents[1]
TRACES = ROOT / "benchmarks" / "traces"
TORCH, JAX = SIDES
SEED = 0


@pytest.fixture(autouse=True)
def _fresh_registries():
    for m in (obs, jobs):
        m.reset()
    yield
    for m in (obs, jobs):
        m.reset()


# =============================================================================
# tenants, QoSConfig, traces, governor
# =============================================================================

def _spec_tuple(t):
    return (t.name, t.tier_class, t.priority, t.page_weight, t.slo)


def test_tenant_classes_and_config_match_jax():
    from repro.qos.tenants import CLASS_DEFAULTS as J_DEFAULTS
    from repro.qos.tenants import DEFAULT_TENANT as J_DEFAULT
    assert qos.__all__ == jqos.__all__
    assert qos.CLASSES == jqos.CLASSES
    assert {c: (p, w, s.__dict__) for c, (p, w, s) in
            CLASS_DEFAULTS.items()} == \
        {c: (p, w, s.__dict__) for c, (p, w, s) in J_DEFAULTS.items()}
    assert _spec_tuple(DEFAULT_TENANT)[:4] == _spec_tuple(J_DEFAULT)[:4]
    for cls in qos.CLASSES:
        for kw in ({}, {"priority": 7}, {"page_weight": 2.5}):
            t = qos.tenant_for_class("x", cls, **kw)
            j = jqos.tenant_for_class("x", cls, **kw)
            assert _spec_tuple(t)[:4] == _spec_tuple(j)[:4]
            assert t.slo.__dict__ == j.slo.__dict__
    for pkg in (qos, jqos):
        lc = pkg.tenant_for_class("lc", pkg.LATENCY_CRITICAL)
        bat = pkg.tenant_for_class("bat", pkg.BATCH)
        cfg = pkg.QoSConfig(tenants=(lc, bat))
        assert cfg.spec("lc") is lc and cfg.spec("bat") is bat
        assert cfg.spec("nobody").name == cfg.spec(None).name == "default"
        assert cfg.any_weighted
        assert not pkg.QoSConfig(tenants=(bat,)).any_weighted
        assert not pkg.QoSConfig().any_weighted


@pytest.mark.parametrize("kw", [dict(tier_class="gold"),
                                dict(page_weight=0.0),
                                dict(page_weight=-1.0)])
def test_tenant_validation_errors_match_jax(kw):
    msgs = []
    for pkg in (qos, jqos):
        with pytest.raises(ValueError) as e:
            pkg.TenantSpec(name="t", **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kw", [dict(tier_class="gold"),
                                dict(process="lognormal")])
def test_arrival_spec_validation_matches_jax(kw):
    msgs = []
    for mod in (traces, jtraces):
        with pytest.raises(ValueError) as e:
            mod.ArrivalSpec("t", **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _events(evs):
    return [(e.rid, e.t, e.tenant, e.cls, e.prompt, e.max_new) for e in evs]


@pytest.mark.parametrize("name", sorted(jtraces.canonical_specs()))
def test_canonical_traces_match_jax_and_committed_bytes(name, tmp_path):
    specs, dur, seed = traces.canonical_specs()[name]
    jspecs, jdur, jseed = jtraces.canonical_specs()[name]
    assert (dur, seed) == (jdur, jseed)
    meta, evs = traces.generate_trace(name, specs, dur, seed)
    jmeta, jevs = jtraces.generate_trace(name, jspecs, jdur, jseed)
    assert meta == jmeta
    assert _events(evs) == _events(jevs)
    assert [e.step(meta["steps_per_s"]) for e in evs] == \
        [e.step(jmeta["steps_per_s"]) for e in jevs]
    p = traces.write_trace(tmp_path / "port.jsonl", meta, evs)
    jp = jtraces.write_trace(tmp_path / "jax.jsonl", jmeta, jevs)
    assert p.read_bytes() == jp.read_bytes() == \
        (TRACES / f"{name}.jsonl").read_bytes()
    rmeta, revs = traces.read_trace(TRACES / f"{name}.jsonl")
    assert rmeta == meta and _events(revs) == _events(evs)


def test_write_canonical_and_custom_streams_match_jax(tmp_path):
    """All three processes, a stream added without perturbing the others,
    and ``write_canonical``'s files."""
    def specs(m):
        return [m.ArrivalSpec("a", process="poisson", rate_rps=5.0),
                m.ArrivalSpec("b", tier_class="batch", process="bursty",
                              rate_rps=6.0, burst_size=3),
                m.ArrivalSpec("c", process="diurnal", rate_rps=4.0)]
    for extra in ([], ["d"]):
        got = traces.generate_trace(
            "t", specs(traces) + [traces.ArrivalSpec(n) for n in extra],
            3.0, seed=42)
        want = jtraces.generate_trace(
            "t", specs(jtraces) + [jtraces.ArrivalSpec(n) for n in extra],
            3.0, seed=42)
        assert got[0] == want[0] and _events(got[1]) == _events(want[1])
    paths = traces.write_canonical(tmp_path / "port")
    jpaths = jtraces.write_canonical(tmp_path / "jax")
    assert [p.name for p in paths] == [p.name for p in jpaths]
    for p, jp in zip(paths, jpaths):
        assert p.read_bytes() == jp.read_bytes()


def _gov_state(g):
    return (g.throttle, g.last_power_mw, g.peak_power_mw,
            g.over_budget_passes, g._calm, g.pressure, g.batch_limit(4),
            g.batch_limit(1))


@pytest.mark.parametrize("recover", [1, 2, 3])
def test_power_governor_matches_jax_per_reading(recover):
    rng = np.random.RandomState(recover)
    readings = np.concatenate([rng.uniform(0, 200, 40),
                               np.full(12, 1e9), np.zeros(30)])
    g = qos.PowerGovernor(budget_mw=100.0, recover_passes=recover)
    jg = jqos.PowerGovernor(budget_mw=100.0, recover_passes=recover)
    assert _gov_state(g) == _gov_state(jg)
    for r in readings:
        assert g.observe(float(r)) == jg.observe(float(r))
        assert _gov_state(g) == _gov_state(jg)
    assert g.throttle == 0 and g.over_budget_passes > 12


# =============================================================================
# MemosManager: the governor and page weights on one seeded store
# =============================================================================

POWER_FIELDS = ("power_pressure", "power_throttle", "power_mw")


def _drive(side, mgr, n_steps=48, weights=()):
    """The phased hot-set scenario of ``helpers.memos_pair.drive`` over
    more steps, with ``weights`` = [(step, pages, weight)] applied after
    that step's ``maybe_step`` (a weight set while a plan is in flight
    on the overlapped path)."""
    sm = side.sm_init(mgr.store)
    rng = np.random.RandomState(7)
    for step in range(n_steps):
        phase = (step // 8) % 4
        sm = side.record(sm, np.arange(phase * 6, phase * 6 + 6), True)
        sm = side.record(sm, rng.randint(20, 32, size=3), False)
        sm, _ = mgr.maybe_step(sm)
        for s, pages, w in weights:
            if s == step:
                mgr.set_page_weight(pages, w)
    mgr.flush()
    return sm


def _power_state(mgr):
    out = [{f: getattr(r, f) for f in POWER_FIELDS} for r in mgr.reports]
    g = mgr.governor
    return out, None if g is None else _gov_state(g)


def _peak_power():
    store = TORCH.store()
    mgr = TORCH.manager(store, interval=4)
    _drive(TORCH, mgr)
    return max(r.power_mw for r in mgr.reports)


WEIGHTS = [(-1, [0, 1, 2], 4.0), (9, [6, 7], 3.0), (20, [0, 1], 1.0)]


@pytest.mark.parametrize("async_plan", [False, True])
@pytest.mark.parametrize("frac,weighted", [(None, True), (0.3, False),
                                           (0.3, True)])
def test_memos_power_and_weights_match_jax(async_plan, frac, weighted):
    budget = None if frac is None else frac * _peak_power()
    states, powers = [], []
    for side in SIDES:
        store = side.store()
        mgr = side.manager(store, interval=4, async_plan=async_plan,
                           power_cap_mw=budget)
        w = WEIGHTS if weighted else ()
        for s, pages, wt in w:
            if s < 0:
                mgr.set_page_weight(pages, wt)
        _drive(side, mgr, weights=[x for x in w if x[0] >= 0])
        st = collect(store, mgr)
        st["power"] = _power_state(mgr)
        st["page_weight"] = (None if mgr._page_weight is None
                             else mgr._page_weight.tolist())
        states.append(st)
        powers.append(st["power"])
        mgr.close()
    got, want = states
    assert_same_state(got, want)
    reps, gov = powers[0]
    if budget is not None:
        assert gov is not None and gov[3] > 0          # over-budget passes
        assert any(r["power_throttle"] > 0 for r in reps)
        assert any(r["power_pressure"] for r in reps)
    else:
        assert gov is None
        assert not any(r["power_pressure"] or r["power_throttle"]
                       for r in reps)
    assert (got["page_weight"] is None) == (not weighted)


def test_weights_and_pressure_change_the_plan():
    """Neither hook is vacuous on this scenario: page weights alone, and
    the power cap alone, each give another page table than the plain
    run (the JAX manager agrees, above)."""
    def run(weight=1.0, **kw):
        store = TORCH.store()
        mgr = TORCH.manager(store, interval=4, **kw)
        mgr.set_page_weight([0, 1, 2, 3, 4, 5], weight)
        _drive(TORCH, mgr)
        return collect(store, mgr)["reports"]
    plain = run()
    assert run(weight=4.0) != plain
    assert run(power_cap_mw=0.3 * _peak_power()) != plain


def test_page_weight_is_lazy_and_snapshotted_like_jax():
    for side in SIDES:
        store = side.store()
        mgr = side.manager(store, interval=4, async_plan=True)
        mgr.set_page_weight([1, 2], 1.0)
        assert mgr._page_weight is None, side.pkg
        sm = side.sm_init(store)
        rng = np.random.RandomState(0)
        sm = record4(side, sm, rng)
        sm, _ = mgr.maybe_step(sm, steps=4)  # begins an overlapped pass
        t = mgr._ticket
        assert t is not None and t.page_weight is None
        mgr.set_page_weight([3], 2.0)       # arrives mid-plan
        assert t.page_weight is None and mgr._page_weight[3] == 2.0
        sm = record4(side, sm, rng)
        sm, rep = mgr.maybe_step(sm, steps=4)  # commits, snapshots the next
        assert rep is not None and rep.committed_async
        t2 = mgr._ticket
        assert t2.page_weight is not mgr._page_weight
        assert_same(t2.page_weight, mgr._page_weight)
        mgr.set_page_weight([3], 5.0)
        assert t2.page_weight[3] == 2.0
        assert mgr._page_weight.dtype == np.float64
        assert mgr._page_weight.shape == (store.tier.shape[0],)
        mgr.close()


def test_power_gauges_publish_like_jax():
    budget = 0.3 * _peak_power()
    flats = []
    for side, reg in ((TORCH, obs), (JAX, jobs)):
        reg.reset()
        store = side.store()
        mgr = side.manager(store, interval=4, power_cap_mw=budget)
        _drive(side, mgr)
        flats.append({k: v for k, v in reg.get_registry().flat().items()
                      if k.startswith("power.")})
    assert flats[0] == flats[1]
    assert set(flats[0]) == {"power.dynamic_mw", "power.throttle",
                             "power.budget_mw", "power.over_budget_passes"}
    assert flats[0]["power.budget_mw"] == budget


# =============================================================================
# the engine at smoke width
# =============================================================================

@pytest.fixture(scope="module")
def models():
    tcfg = smoke(registry()["qwen3_4b"])
    jcfg = jsmoke(jregistry()["qwen3_4b"])
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(SEED))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return tcfg, tparams, jcfg, jparams


def _tenants(pkg):
    return (pkg.tenant_for_class("lc", pkg.LATENCY_CRITICAL),
            pkg.tenant_for_class("std", pkg.STANDARD),
            pkg.tenant_for_class("bat", pkg.BATCH))


def _qos(pkg, kind, budget=None):
    if kind is None:
        return None
    if kind == "bare":
        return pkg.QoSConfig(power_budget_mw=budget)
    return pkg.QoSConfig(tenants=_tenants(pkg), power_budget_mw=budget)


def _engine(models, side, qos_kind, budget=None, **kw):
    tcfg, tparams, jcfg, jparams = models
    scfg = dict(page_size=8, max_batch=2, fast_slots=12, slow_slots=128,
                memos_interval=5)
    scfg.update(kw)
    if side == "torch":
        return PagedServingEngine(tcfg, tparams, ServeConfig(
            qos=_qos(qos, qos_kind, budget), **scfg), device="cpu")
    return JEngine(jcfg, jparams, JServeConfig(
        qos=_qos(jqos, qos_kind, budget), **scfg))


def _serve(models, side, qos_kind, submits, budget=None, **kw):
    eng = _engine(models, side, qos_kind, budget, **kw)
    reqs = [eng.submit(p, max_new=n, tenant=t) for p, n, t in submits]
    eng.run(max_steps=600)
    assert eng.batcher.all_done()
    eng.close()
    return eng, reqs


def _req_state(r):
    return (r.rid, r.tenant, r.priority, r.weight, r.arrival, r.start_step,
            r.first_token_step, r.finish_step, r.generated, r.tokens,
            r.error is None)


REPORT_FIELDS = ("step", "n_marked", "fast_pages", "slow_pages", "spilled",
                 "tier_pages", "wear_pressure") + POWER_FIELDS


def _engine_state(eng, reqs):
    return {
        "reqs": [_req_state(r) for r in reqs],
        "finished": [r.rid for r in eng.batcher.finished],
        "n_preempted": eng.batcher.n_preempted,
        "n_admitted": eng.batcher.n_admitted,
        "steps": eng.step_count,
        "tokens_out": eng.tokens_out,
        "tier": eng.kv.store.tier.copy(),
        "slot": eng.kv.store.slot.copy(),
        "traffic": dict(eng.kv.store.traffic),
        "reports": [({f: getattr(r, f) for f in REPORT_FIELDS},
                     r.migrations.to_dict()) for r in eng.memos.reports],
        "governor": (None if eng.memos.governor is None
                     else _gov_state(eng.memos.governor)),
        "page_weight": (None if eng.memos._page_weight is None
                        else eng.memos._page_weight.tolist()),
    }


def _assert_engines_equal(t, j):
    teng, treqs = t
    jeng, jreqs = j
    got, want = _engine_state(teng, treqs), _engine_state(jeng, jreqs)
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert_same(got[k], want[k])
        else:
            assert got[k] == want[k], k
    assert_close(teng.kv.store.fast_pool, np.asarray(jeng.kv.store.fast_pool))


# three sequences of up to 25 tokens over 6 HBM slots of 8-token pages:
# preemption, demotion and promotion all happen
PRESSURE = [([5, 7, 9, 11, 13], 16, None), ([21, 22, 23], 16, None),
            ([1, 2, 3, 4, 5, 6, 7, 8, 9], 16, None)]


def test_bare_qos_config_equals_none_and_jax(models):
    """With no tenants and no budget the engine serves exactly as
    ``qos=None``, under preemption and across memos passes; both equal
    the JAX engine's bare-QoS run."""
    runs = {(side, kind): _serve(models, side, kind, PRESSURE, max_batch=3,
                                 fast_slots=6)
            for side in ("torch", "jax") for kind in (None, "bare")}
    t_none, t_bare = runs[("torch", None)], runs[("torch", "bare")]
    assert t_none[0].batcher.n_preempted > 0
    _assert_engines_equal(t_bare, runs[("jax", "bare")])
    _assert_engines_equal(t_none, runs[("jax", None)])
    a, b = _engine_state(*t_none), _engine_state(*t_bare)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert_same(a[k], b[k])
        else:
            assert a[k] == b[k], k
    assert t_bare[0].memos.governor is None
    assert not t_bare[0].batcher.priority_aware
    assert_same(t_none[0].kv.store.fast_pool, t_bare[0].kv.store.fast_pool)


def test_priority_reorders_service_like_jax(models):
    """One decode slot, two queued batch requests, then an LC arrival:
    the aware engine serves LC before a queued batch request, as the JAX
    engine does; the blind engine serves FIFO; tokens do not depend on
    the order."""
    submits = [([3, 4, 5], 4, "bat"), ([6, 7, 8], 4, "bat"),
               ([9, 10, 11], 4, "lc")]
    kw = dict(max_batch=1, fast_slots=32)
    aware = _serve(models, "torch", "tenants", submits, **kw)
    _assert_engines_equal(aware, _serve(models, "jax", "tenants", submits,
                                        **kw))
    blind = _serve(models, "torch", None, submits, **kw)
    assert [r.rid for r in blind[0].batcher.finished] == [0, 1, 2]
    assert [r.tenant for r in aware[0].batcher.finished].index("lc") < 2
    assert aware[1][2].first_token_step < blind[1][2].first_token_step
    for ra, rb in zip(aware[1], blind[1]):
        assert ra.generated == rb.generated
    assert aware[1][2].priority > aware[1][0].priority
    assert aware[1][2].weight == 4.0 and aware[1][0].weight == 1.0


def test_tenant_histograms_publish_like_jax(models):
    submits = [([5, 6, 7], 4, "lc"), ([8, 9, 10], 4, None),
               ([11, 12], 1, "bat")]
    flats = []
    for side, reg in (("torch", obs), ("jax", jobs)):
        reg.reset()
        eng, reqs = _serve(models, side, "tenants", submits, prefill=True)
        for r in reqs:
            assert r.finish_ts >= r.first_token_ts >= r.submit_ts
            assert r.e2e_s >= r.ttft_s >= 0
        flats.append(reg.get_registry().flat())
    tf, jf = flats
    keys = sorted(k for k in jf if k.startswith(("qos.", "serving.ttft",
                                                 "serving.e2e")))
    assert sorted(k for k in tf if k.startswith(
        ("qos.", "serving.ttft", "serving.e2e"))) == keys
    counts = [k for k in keys if k.endswith(".count")]
    assert {k: tf[k] for k in counts} == {k: jf[k] for k in counts}
    assert tf["serving.ttft_s.count"] == tf["serving.e2e_latency_s.count"] \
        == 3
    assert tf["qos.ttft_s.lc.count"] == tf["qos.ttft_s.default.count"] == 1
    assert tf["qos.itl_s.lc.count"] == 3      # max_new - 1 token gaps
    assert "qos.itl_s.bat.count" not in tf    # one token: no gap
    assert tf["serving.admissions"] == jf["serving.admissions"] >= 3


def test_power_cap_narrows_admission_like_jax(models):
    """A tight budget raises the governor's throttle (admission narrows
    below max_batch) along the JAX governor's trajectory, and releases
    it; without a budget there is no governor."""
    submits = [([i + 1, i + 2, i + 3], 8, None) for i in range(6)]
    kw = dict(max_batch=4, fast_slots=4, slow_slots=128, memos_interval=4)
    free = _serve(models, "torch", "bare", submits, **kw)
    assert free[0].memos.governor is None
    peak = max(r.power_mw for r in free[0].memos.reports)
    assert peak > 0
    assert peak == max(r.power_mw for r in _serve(
        models, "jax", "bare", submits, **kw)[0].memos.reports)
    jobs.reset()
    obs.reset()
    capped = _serve(models, "torch", "bare", submits, budget=0.2 * peak,
                    **kw)
    jcapped = _serve(models, "jax", "bare", submits, budget=0.2 * peak,
                     **kw)
    _assert_engines_equal(capped, jcapped)
    eng = capped[0]
    throttles = [r.power_throttle for r in eng.memos.reports]
    assert eng.memos.governor.over_budget_passes > 0 and max(throttles) > 0
    assert any(r.power_pressure for r in eng.memos.reports)
    assert all(r.generated for r in capped[1])
    tf = {k: v for k, v in obs.get_registry().flat().items()
          if k.startswith("power.")}
    jf = {k: v for k, v in jobs.get_registry().flat().items()
          if k.startswith("power.")}
    assert tf == jf and tf["power.budget_mw"] == pytest.approx(0.2 * peak)


@pytest.mark.parametrize("aware", [True, False])
def test_scheduler_admit_and_preempt_match_jax(aware):
    """Seeded random submits, ``admit(limit)``, ``preempt_lowest(
    max_priority)`` and finishes on the port's and the JAX package's
    ``ContinuousBatcher``: the same decisions at every call, and no
    admission past ``limit`` running rows."""
    from repro.serving.scheduler import ContinuousBatcher as JBatcher
    from repro.serving.scheduler import Request as JRequest
    from repro_torch.serving.scheduler import ContinuousBatcher, Request
    rng = np.random.RandomState(5)
    sides = [(ContinuousBatcher(4, priority_aware=aware), Request),
             (JBatcher(4, priority_aware=aware), JRequest)]
    reqs = [{}, {}]
    rid = 0

    def state(b):
        return (sorted((s, r.rid) for s, r in b.running.items()),
                [r.rid for r in b.waiting], [r.rid for r in b.preempted],
                [r.rid for r in b.finished], b.n_admitted, b.n_preempted)
    for step in range(300):
        op = rng.randint(4)
        prio = int(rng.randint(3))
        limit = None if rng.rand() < 0.3 else int(rng.randint(1, 5))
        maxp = None if rng.rand() < 0.3 else int(rng.randint(-1, 3))
        out = []
        for (b, R), rs in zip(sides, reqs):
            if op == 0:
                r = R(rid, [1], 2, arrival=step)
                r.priority = prio
                rs[rid] = r
                b.submit(r)
                out.append(rid)
            elif op == 1:
                got = b.admit(limit)
                for r in got:
                    r.start_step = step
                if got and limit is not None:
                    assert len(b.running) <= limit
                out.append([r.rid for r in got])
            elif op == 2:
                v = b.preempt_lowest(maxp)
                out.append(None if v is None else v.rid)
            elif b.running:
                r = b.running[min(b.running)]
                b.finish(r, step)
                out.append(r.rid)
        rid += op == 0
        assert out[:1] == out[1:], (step, op, out)
        assert state(sides[0][0]) == state(sides[1][0]), step
    assert sides[0][0].n_admitted > 20 and sides[0][0].n_preempted > 20


def test_report_roundtrip_with_power_fields(models):
    eng, _ = _serve(models, "torch", "bare", [([5, 6, 7], 6, None)],
                    budget=0.001, memos_interval=4)
    r = eng.memos.reports[-1]
    rt = MemosReport.from_dict(r.to_dict())
    assert (rt.power_mw, rt.power_throttle, rt.power_pressure) == \
        (r.power_mw, r.power_throttle, r.power_pressure)
    flat = r.flat_metrics()
    assert flat["power_mw"] == r.power_mw
    assert flat["power_throttle"] == r.power_throttle
    jeng, _ = _serve(models, "jax", "bare", [([5, 6, 7], 6, None)],
                     budget=0.001, memos_interval=4)
    jr = jeng.memos.reports[-1]
    assert {f: getattr(r, f) for f in POWER_FIELDS} == \
        {f: getattr(jr, f) for f in POWER_FIELDS}
    assert set(r.flat_metrics()) == set(jr.flat_metrics())


# =============================================================================
# trace replay on the step clock
# =============================================================================

def _replay(engine, meta, events, max_steps=20_000):
    """Open-loop replay: each event is submitted once the engine's step
    clock reaches ``floor(t * steps_per_s)``."""
    pending = deque(events)
    reqs = {}
    while pending or not engine.batcher.all_done():
        while pending and \
                pending[0].step(meta["steps_per_s"]) <= engine.step_count:
            ev = pending.popleft()
            reqs[ev.rid] = engine.submit(ev.prompt, ev.max_new,
                                         tenant=ev.tenant)
        engine.step()
        assert engine.step_count < max_steps, "replay did not drain"
    return [reqs[rid] for rid in sorted(reqs)]


def _replay_engine(models, side, qos_kind, budget=None):
    """qos_bench's engine at smoke width, over a numpy host tier (the
    JAX pinned pool aborts on this CPU)."""
    tcfg, tparams, jcfg, jparams = models
    kw = dict(page_size=8, max_batch=4, fast_slots=12, slow_slots=96,
              memos_interval=8, memos_enabled=True, max_pages_per_seq=8,
              decode_block=4, overlap_plan=False, prefill=True)
    if side == "torch":
        return PagedServingEngine(tcfg, tparams, ServeConfig(
            hierarchy=MemoryHierarchy.two_tier(12, 96),
            qos=_qos(qos, qos_kind, budget), **kw), device="cpu")
    return JEngine(jcfg, jparams, JServeConfig(
        hierarchy=JHierarchy.two_tier(12, 96),
        qos=_qos(jqos, qos_kind, budget), **kw))


def _replayed(models, name, side, qos_kind, budget=None, n_events=12):
    meta, events = traces.read_trace(TRACES / f"{name}.jsonl")
    eng = _replay_engine(models, side, qos_kind, budget)
    reqs = _replay(eng, meta, events[:n_events])
    eng.close()
    return eng, reqs


@pytest.mark.parametrize("qos_kind", ["tenants", None])
def test_mixed_overload_prefix_replay_matches_jax(models, qos_kind):
    t = _replayed(models, "mixed_overload", "torch", qos_kind)
    j = _replayed(models, "mixed_overload", "jax", qos_kind)
    _assert_engines_equal(t, j)
    assert len(t[1]) == 12 and all(r.error is None for r in t[1])
    assert {r.tenant for r in t[1]} == {"lc", "std"}   # bat arrives later


def test_steady_power_prefix_replay_matches_jax(models):
    free = _replayed(models, "steady_power", "torch", "bare")
    _assert_engines_equal(free, _replayed(models, "steady_power", "jax",
                                          "bare"))
    peak = max(r.power_mw for r in free[0].memos.reports)
    assert peak > 0 and free[0].memos.governor is None
    capped = _replayed(models, "steady_power", "torch", "bare",
                       budget=0.5 * peak)
    _assert_engines_equal(capped, _replayed(models, "steady_power", "jax",
                                            "bare", budget=0.5 * peak))
    gov = capped[0].memos.governor
    assert gov.over_budget_passes > 0
    assert any(r.power_throttle > 0 for r in capped[0].memos.reports)
    assert all(r.error is None for r in capped[1])
