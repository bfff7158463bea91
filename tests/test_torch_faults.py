"""The port's fault layer against the JAX package's (``repro.faults``).

Twins of ``tests/test_faults.py`` on the port's stores — the numpy host
pool and the pinned-host pool — held against the JAX numpy-host store
where the JAX package can run (its pinned pool aborts on this CPU,
ROADMAP C1): the same seed over the same store state must inject the
same faults, the checksums must catch every single-bit flip, quarantine
must retire slots the same way, and the migration retry, pre-flight and
degradation ladder (overlap, sync, memos-off) must make the same
decisions; the plan-worker site draws the same faults per seed.  Everything compared
here is integer or stored-bit state, so it is compared exactly.  The
last test is a media storm on the port's pinned engine: no request
ever emits a corrupted token.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_same, cap_threads
from repro import faults as jfaults
from repro import obs as jobs
from repro.core import hierarchy as jhierarchy
from repro.core import migration as jmigration
from repro.core import sysmon as jsysmon
from repro.core import tiers as jtiers
from repro.core.memos import MemosConfig as JMemosConfig
from repro.core.memos import MemosManager as JMemosManager
from repro_torch import faults, obs
from repro_torch.configs.base import registry, smoke
from repro_torch.core import memos as memos_mod
from repro_torch.core import sysmon, tiers
from repro_torch.core.hierarchy import MemoryHierarchy
from repro_torch.core.memos import MemosConfig, MemosManager
from repro_torch.core.migration import BatchedMigrationEngine
from repro_torch.faults import (RUNG_OFF, RUNG_OVERLAP, RUNG_SYNC,
                                DegradationLadder, FaultConfig,
                                FaultInjector, InjectedPlanFault,
                                PageCorruptionError)
from repro_torch.models.transformer import init_params
from repro_torch.serving.engine import PagedServingEngine, ServeConfig

cap_threads()


@pytest.fixture(autouse=True)
def _clean_global_state():
    for m in (faults, obs, jfaults, jobs):
        m.reset()
    yield
    for m in (faults, obs, jfaults, jobs):
        m.reset()


def _store(pinned, dtype, seed, enabled=True):
    """A populated two-tier store of the port (the injector is armed
    first: the store latches it into its PageIntegrity)."""
    if enabled:
        faults.configure(FaultConfig(seed=seed))
    hier = MemoryHierarchy.two_tier(8, 32, pinned_slow=pinned,
                                    gap_write_interval=5)
    store = tiers.TierStore(tiers.StoreConfig(
        n_pages=32, page_shape=(8,), hierarchy=hier, dtype=dtype,
        n_banks=2, n_slabs=4), device="cpu")
    _fill(store, seed)
    return store


def _jstore(dtype, seed):
    """The JAX numpy-host twin of ``_store``."""
    jfaults.configure(jfaults.FaultConfig(seed=seed))
    store = jtiers.TierStore(jtiers.StoreConfig(
        n_pages=32, page_shape=(8,), dtype=dtype, n_banks=2, n_slabs=4,
        hierarchy=jhierarchy.MemoryHierarchy.two_tier(
            8, 32, gap_write_interval=5)))
    _fill(store, seed)
    return store


def _fill(store, seed):
    rng = np.random.RandomState(seed)
    for p in range(32):
        assert store.allocate(p, int(store.tier[p]))
        store.write_page(p, rng.standard_normal(8).astype(np.float32))


def _slow(store):
    t = store.hierarchy.deepest
    live = np.nonzero((store.tier == t) & (store.slot != -1))[0]
    return t, [int(store.slot[p]) for p in live], live


def _raw(store, t):
    pool = store.pools[t]
    return pool.raw() if hasattr(pool, "raw") else pool.data


# =============================================================================
# checksums
# =============================================================================

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pinned", [False, True])
def test_checksum_catches_every_flip(pinned, dtype, seed):
    """Every injected single-bit flip of a numpy host pool or a pinned
    pool is caught by ``verify``, the un-flipped page never fires, and
    the recorded checksums equal the JAX numpy store's for the same
    pages."""
    store = _store(pinned, dtype, seed)
    t, slots, _ = _slow(store)
    assert slots and store.integrity.enabled
    jstore = _jstore(jnp.float32 if dtype == torch.float32
                     else jnp.bfloat16, seed)
    assert store.integrity.sums == jstore.integrity.sums
    assert store.integrity.verify(store, t, slots) == []
    raw = _raw(store, t)
    row_bytes = FaultInjector._row_bytes(raw)
    rng = np.random.RandomState(100 + seed)
    for _ in range(20):
        s = int(rng.choice(slots))
        phys = int(store._phys(t, np.asarray([s]))[0])
        byte, bit = int(rng.randint(row_bytes)), int(rng.randint(8))
        FaultInjector._xor_bit(raw, phys, byte, bit)
        assert store.integrity.verify(store, t, slots) == [s], \
            f"missed flip at slot {s} byte {byte} bit {bit}"
        FaultInjector._xor_bit(raw, phys, byte, bit)      # undo
        assert store.integrity.verify(store, t, slots) == []


def test_scrub_finds_and_disarmed_store_is_inert():
    store = _store(True, torch.bfloat16, seed=5)
    t, slots, _ = _slow(store)
    phys = int(store._phys(t, np.asarray([slots[0]]))[0])
    FaultInjector._xor_bit(_raw(store, t), phys, 0, 3)
    bad = []
    for _ in range(8):
        bad += store.integrity.scrub(store, budget=8)
    assert (t, slots[0]) in bad
    faults.reset()
    off = _store(True, torch.bfloat16, seed=5, enabled=False)
    assert not off.integrity.enabled and off.integrity.sums == {}
    t2, slots2, _ = _slow(off)
    assert off.integrity.verify(off, t2, slots2) == []
    assert off.integrity.scrub(off, budget=8) == []


# =============================================================================
# the injector
# =============================================================================

@pytest.mark.parametrize("pinned", [False, True])
def test_injector_matches_jax_per_seed_and_inert_when_disarmed(pinned):
    """Same seed, same store state: the port's injector corrupts the same
    bits as the JAX injector (on a numpy or a pinned pool), and is
    deterministic; a disarmed injector changes nothing."""
    cfg = dict(seed=11, media_flip_rate=0.2, media_stuck_rate=0.05)
    outs = []
    for _ in range(2):
        store = _store(pinned, torch.float32, seed=1)
        inj = FaultInjector(FaultConfig(**cfg))
        n = sum(inj.tick(store) for _ in range(5))
        outs.append((n, dict(inj.counts), _raw(store, 1).copy()))
    jstore = _jstore(jnp.float32, seed=1)
    jinj = jfaults.FaultInjector(jfaults.FaultConfig(**cfg))
    jn = sum(jinj.tick(jstore) for _ in range(5))
    assert outs[0][0] == outs[1][0] == jn > 0
    assert set(outs[0][1]) == set(jinj.counts)
    assert outs[0][1] == outs[1][1] == jinj.counts
    assert_same(outs[0][2], outs[1][2])
    assert_same(outs[0][2], jstore.pools[1].data)

    store = _store(pinned, torch.float32, seed=1)
    before = _raw(store, 1).copy()
    off = FaultInjector(None)
    assert off.tick(store) == 0 and off.total_injected == 0
    assert_same(before, _raw(store, 1))


@pytest.mark.parametrize("seed", [0, 21])
def test_plan_fault_site_matches_jax_per_seed(seed):
    """The plan-worker site draws from its own stream (seed + 1), delay
    first, then exception: 40 jobs inject the same faults, in the same
    order, with the same counts, as the JAX injector; the other sites'
    streams are untouched by it."""
    cfg = dict(seed=seed, plan_exception_rate=0.3, plan_delay_rate=0.4,
               plan_delay_s=1e-4, migrate_fail_rate=0.5)
    runs = []
    for inj in (FaultInjector(FaultConfig(**cfg)),
                jfaults.FaultInjector(jfaults.FaultConfig(**cfg))):
        seq = []
        for _ in range(40):
            before = inj.counts["plan_delay"]
            try:
                inj.maybe_plan_fault()
                seq.append((inj.counts["plan_delay"] - before, 0))
            except Exception as e:
                seq.append((inj.counts["plan_delay"] - before,
                            type(e).__name__))
        migrate = []
        for _ in range(10):
            try:
                inj.maybe_migration_fault(0, 1, 1)
                migrate.append(0)
            except Exception:
                migrate.append(1)
        runs.append((seq, migrate, dict(inj.counts)))
    assert runs[0] == runs[1]
    seq, _, counts = runs[0]
    assert counts["plan_exception"] > 0 and counts["plan_delay"] > 0
    assert {e for _, e in seq} == {0, InjectedPlanFault.__name__}
    off = FaultInjector(None)
    off.maybe_plan_fault()
    assert off.total_injected == 0


@pytest.mark.parametrize("pinned", [False, True])
def test_stuck_at_faults_reassert_after_rewrite(pinned):
    store = _store(pinned, torch.float32, seed=6)
    inj = FaultInjector(FaultConfig(seed=6, media_stuck_rate=0.3))
    jstore = _jstore(jnp.float32, seed=6)
    jinj = jfaults.FaultInjector(jfaults.FaultConfig(seed=6,
                                                     media_stuck_rate=0.3))
    for _ in range(4):
        inj.tick(store)
        jinj.tick(jstore)
    assert inj.counts["media_stuck"] == jinj.counts["media_stuck"] > 0
    assert inj._stuck == jinj._stuck
    phys, byte, bit, val = inj._stuck[1][0]
    # rewrite the byte clean, then tick: the bit re-asserts
    flat = _raw(store, 1)[phys].view(np.uint8).reshape(-1)
    flat[byte] = np.uint8(0 if val else 0xFF)
    inj.tick(store)
    assert (int(_raw(store, 1)[phys].view(np.uint8).reshape(-1)[byte])
            >> bit) & 1 == val


# =============================================================================
# quarantine
# =============================================================================

@pytest.mark.parametrize("pinned", [False, True])
def test_quarantine_retires_slot_and_unbinds_page(pinned):
    store = _store(pinned, torch.float32, seed=8)
    t, slots, live = _slow(store)
    s, owner = slots[0], int(live[0])
    n_free = store.alloc[t].n_free
    assert store.quarantine_slot(t, s, reason="test")
    assert s in store.quarantined[t]
    assert int(store.slot[owner]) == -1
    assert owner in store.quarantine_log
    assert (t, s) not in store.integrity.sums
    assert store.quarantine_slot(t, s) is False          # idempotent
    with pytest.raises(ValueError, match="quarantined"):
        store.alloc[t].free(s, 0)
    store.alloc[t].check_consistency()
    got = []
    while True:
        g = store.alloc[t].alloc(0)
        if g is None:
            break
        got.append(g)
    assert s not in got
    assert store.alloc[t].n_free == 0 and n_free == len(got)
    assert store.alloc[t].n_retired == 1
    assert obs.get_registry().counter("faults.quarantined_slots").value == 1


def test_alloc_injection_drives_allocate_failures():
    store = _store(True, torch.float32, seed=9)
    store.release(0)
    faults.configure(FaultConfig(alloc_fail_rate=1.0))
    assert store.allocate(0, store.hierarchy.deepest) is False
    faults.configure(FaultConfig(alloc_fail_rate=0.0))
    assert store.allocate(0, store.hierarchy.deepest) is True


# =============================================================================
# migration retry / fail closed, promotion pre-flight
# =============================================================================

def _state(store):
    return store.tier.copy(), store.slot.copy()


@pytest.mark.parametrize("pinned", [False, True])
def test_migration_retries_transient_faults_then_fails_closed(pinned):
    """Rate 1.0 fails every attempt: the pages stay where they were and
    every reservation returns.  Rate 0.5 with a deep retry budget rides
    the storm out.  Both match the JAX engine draw for draw."""
    for rate, retries in ((1.0, 3), (0.5, 12)):
        store = _store(pinned, torch.float32, seed=10)
        jstore = _jstore(jnp.float32, seed=10)
        faults.configure(FaultConfig(seed=10, migrate_fail_rate=rate))
        jfaults.configure(jfaults.FaultConfig(seed=10,
                                              migrate_fail_rate=rate))
        eng = BatchedMigrationEngine(store, retry_backoff_s=1e-6,
                                     max_retries=retries)
        jeng = jmigration.make_engine(jstore, "batched")
        jeng.retry_backoff_s, jeng.max_retries = 1e-6, retries
        pages = [int(p) for p in _slow(store)[2][:4]]
        before = _state(store)
        st, jst = eng.migrate_locked(pages, 0), jeng.migrate_locked(pages, 0)
        assert (st.migrated, st.failed) == (jst.migrated, jst.failed)
        assert faults.get_injector().counts["migrate"] == \
            jfaults.get_injector().counts["migrate"] > 0
        for a, b in zip(_state(store), _state(jstore)):
            assert_same(a, b)
        if rate == 1.0:
            assert st.migrated == 0 and st.failed >= len(pages)
            for a, b in zip(before, _state(store)):
                assert_same(a, b)
        else:
            assert st.migrated == 4 and st.failed == 0
            assert obs.get_registry().counter(
                "faults.recovered_migrate_retry").value > 0
        for t in range(store.n_tiers):
            store.alloc[t].check_consistency()


@pytest.mark.parametrize("pinned", [False, True])
def test_promotion_preflight_quarantines_corrupt_source(pinned):
    """A corrupt slow-tier page is never promoted: the pre-flight verify
    quarantines its slot, the owner lands in the quarantine log, and the
    other planned pages still move — as in the JAX engine."""
    store = _store(pinned, torch.float32, seed=12)
    jstore = _jstore(jnp.float32, seed=12)
    t, _, live = _slow(store)
    victim = int(live[0])
    vslot = int(store.slot[victim])
    for s in (store, jstore):
        raw = _raw(s, t)
        FaultInjector._xor_bit(raw, int(s._phys(t, np.asarray([vslot]))[0]),
                               1, 5)
    pages = [int(p) for p in live[:4]]
    st = BatchedMigrationEngine(store).migrate_locked(pages, 0)
    jst = jmigration.make_engine(jstore, "batched").migrate_locked(pages, 0)
    assert st.failed == jst.failed == 1
    assert st.migrated == jst.migrated == len(pages) - 1
    assert store.quarantine_log == jstore.quarantine_log == [victim]
    assert store.quarantined == jstore.quarantined
    for a, b in zip(_state(store), _state(jstore)):
        assert_same(a, b)
    for tt in range(store.n_tiers):
        store.alloc[tt].check_consistency()


# =============================================================================
# the degradation ladder and the memos pass
# =============================================================================

def test_ladder_unit_semantics_match_jax():
    """The overlap/sync/memos-off ladder walks exactly as the JAX ladder
    with the same top rung does, from either top; by default its top is
    overlap, as the JAX ladder's is."""
    walk = ["f", "f", "h", "h", "h", "h", "f", "h", "h", "h", "f", "f",
            "h", "h", "h", "h", "h", "h", "h", "f"]
    for top in (RUNG_SYNC, RUNG_OVERLAP):
        lad = DegradationLadder(top=top, recovery_passes=3)
        jlad = jfaults.DegradationLadder(top=top, recovery_passes=3)
        assert lad.rung == top and lad.rung_name == jlad.rung_name
        for op in walk:
            a = lad.record_failure(op) if op == "f" else lad.record_healthy()
            b = (jlad.record_failure(op) if op == "f"
                 else jlad.record_healthy())
            assert (a, lad.rung, lad.rung_name) == (b, jlad.rung,
                                                    jlad.rung_name)
        assert (lad.demotions, lad.promotions, lad.failures) == \
            (jlad.demotions, jlad.promotions, jlad.failures)
    assert DegradationLadder().top == jfaults.DegradationLadder().top \
        == RUNG_OVERLAP
    assert DegradationLadder().rung_name == "overlap"
    with pytest.raises(ValueError):
        DegradationLadder(top=3)


def _record4(sm, record, seed=7):
    rng = np.random.RandomState(seed)
    for _ in range(4):
        sm = record(sm, np.arange(6), True)
        sm = record(sm, rng.randint(20, 32, 3), False)
    return sm


def test_memos_ladder_walks_to_memos_off_and_back_like_jax(monkeypatch):
    """Every pass fails its migrations (rate 1.0): the synchronous pass
    demotes the ladder to memos-off; once the storm stops, healthy
    passes re-promote it.  Rungs, reports and placement match the JAX
    synchronous manager pass for pass."""
    store = _store(False, torch.float32, seed=15)
    jstore = _jstore(jnp.float32, seed=15)
    faults.configure(FaultConfig(seed=15, migrate_fail_rate=1.0))
    jfaults.configure(jfaults.FaultConfig(seed=15, migrate_fail_rate=1.0))
    kw = dict(interval=4, adaptive_interval=False)
    monkeypatch.setattr(memos_mod, "BREAKER_RECOVERY_PASSES", 2)
    mgr = MemosManager(store, MemosConfig(**kw))
    jmgr = JMemosManager(jstore, JMemosConfig(breaker_recovery_passes=2,
                                              **kw))
    mgr.engine.retry_backoff_s = jmgr.engine.retry_backoff_s = 1e-6
    sm = sysmon.init(32, store.cfg.n_banks, store.cfg.n_slabs, device="cpu")
    jsm = jsysmon.init(32, jstore.cfg.n_banks, jstore.cfg.n_slabs)

    def rec(s, ids, w):
        return sysmon.record(s, torch.from_numpy(ids.astype(np.int32)),
                             is_write=w)

    def jrec(s, ids, w):
        return jsysmon.record(s, jnp.asarray(ids, jnp.int32), is_write=w)

    rungs = []
    for i in range(6):
        if i == 2:                                     # the storm stops
            faults.configure(FaultConfig(seed=15))
            jfaults.configure(jfaults.FaultConfig(seed=15))
        sm, rep = mgr.maybe_step(_record4(sm, rec), steps=4)
        jsm, jrep = jmgr.maybe_step(_record4(jsm, jrec), steps=4)
        assert (rep is None) == (jrep is None)
        if rep is not None:
            assert rep.migrations.to_dict() == jrep.migrations.to_dict()
        assert mgr.ladder.rung == jmgr.ladder.rung
        rungs.append(mgr.ladder.rung)
        for a, b in zip(_state(store), _state(jstore)):
            assert_same(a, b)
    assert rungs == [RUNG_SYNC, RUNG_OFF, RUNG_OFF, RUNG_SYNC, RUNG_SYNC,
                     RUNG_SYNC]
    assert mgr.reports[1].migrations.failed > 0
    assert mgr.ladder.demotions == 1 and mgr.ladder.promotions == 1
    assert obs.get_registry().gauge("faults.ladder_rung").value == RUNG_SYNC


# =============================================================================
# a media storm on the pinned engine
# =============================================================================

def test_pinned_engine_media_storm_corrupts_no_token():
    """Media flips and stuck-at bits land in the pinned pool while it
    serves in place: every completed request emits exactly the
    fault-free tokens, every failed one fails with a
    ``PageCorruptionError`` after an exact prefix of them, and faults
    were both injected and caught."""
    cfg = smoke(registry()["qwen3_4b"])
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, size=n).tolist()
               for n in (5, 3, 9, 6, 7, 4)]

    def run():
        eng = PagedServingEngine(cfg, params, ServeConfig(
            page_size=8, max_batch=3, fast_slots=4, slow_slots=64,
            memos_interval=4, decode_block=4,
            hierarchy=MemoryHierarchy.two_tier(4, 64, pinned_slow=True,
                                               gap_write_interval=6)),
            device="cpu")
        reqs = [eng.submit(p, 16) for p in prompts]
        eng.run(max_steps=600)
        assert eng.batcher.all_done()
        return eng, reqs

    _, clean = run()
    assert all(r.error is None for r in clean)
    inj = faults.configure(FaultConfig(seed=3, media_flip_rate=0.03,
                                       media_stuck_rate=0.01))
    eng, storm = run()
    done = [r for r in storm if r.error is None]
    failed = [r for r in storm if r.error is not None]
    assert inj.total_injected > 0
    assert sum(len(q) for q in eng.kv.store.quarantined.values()) > 0
    assert done and failed
    for c, s in zip(clean, storm):
        if s.error is None:
            assert s.generated == c.generated
        else:
            assert isinstance(s.error, PageCorruptionError)
            assert s.generated == c.generated[:len(s.generated)]
