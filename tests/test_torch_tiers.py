"""The port's tiered page store, host policy and NVM telemetry against the
JAX package, exactly.

* the pinned two-tier memos scenario (``helpers/gen_two_tier_golden``)
  replayed through ``repro_torch`` reproduces ``two_tier_golden.npz``
  bit for bit, and its per-pass ``NvmReport``s equal the JAX run's;
* placement plans, allocator slots, and batched migrations (bfloat16
  pages through the uint16 host pool) match from the same inputs;
* wear counters, the Start-Gap remap and the energy reports match.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers.gen_two_tier_golden as golden
from helpers.torch_parity import assert_same, cap_threads
from repro.core import allocator as jallocator
from repro.core import hierarchy as jhierarchy
from repro.core import migration as jmigration
from repro.core import placement as jplacement
from repro.core import sysmon as jsysmon
from repro.core import tiers as jtiers
from repro.nvm import energy as jenergy
from repro_torch.core import allocator, hierarchy, migration, placement, sysmon
from repro_torch.core import tiers
from repro_torch.core.memos import MemosConfig, MemosManager
from repro_torch.nvm import energy

cap_threads()


# =============================================================================
# the pinned two-tier scenario
# =============================================================================

def _port_scenario():
    """``golden.run_scenario`` step for step on the port (CPU tensors)."""
    store = tiers.TierStore(tiers.TierConfig(
        n_pages=32, fast_slots=8, slow_slots=32, page_shape=(4,),
        dtype=torch.float32, n_banks=2, n_slabs=4, gap_write_interval=5),
        device="cpu")
    slow_tier = int(store.tier[0])
    for p in range(32):
        assert store.allocate(p, slow_tier)
        store.write_page(p, np.full(4, float(p), np.float32))
    mgr = MemosManager(store, MemosConfig(interval=4,
                                          adaptive_interval=False))
    sm = sysmon.init(32, store.cfg.n_banks, store.cfg.n_slabs, device="cpu")
    rng = np.random.RandomState(7)
    for step in range(24):
        phase = step // 8
        hot = np.arange(phase * 6, phase * 6 + 6)
        warm = rng.randint(20, 32, size=3)
        sm = sysmon.record(sm, torch.from_numpy(hot.astype(np.int32)),
                           is_write=True)
        sm = sysmon.record(sm, torch.from_numpy(warm.astype(np.int32)),
                           is_write=False)
        if step % 5 == 0 and int(store.tier[hot[0]]) == slow_tier:
            store.write_page(int(hot[0]), np.full(4, 100.0 + step,
                                                  np.float32))
        sm, _ = mgr.maybe_step(sm)
    return store, mgr, sm


def test_two_tier_golden_reproduced():
    ref = np.load(golden.OUT)
    got = golden.collect(*_port_scenario())
    assert set(ref.files) == set(got)
    for key in ref.files:
        np.testing.assert_array_equal(np.asarray(got[key]), ref[key],
                                      err_msg=key)


def test_two_tier_scenario_nvm_reports_match_jax():
    """Every pass's NvmReport (counts, energy, lifetime) and the leveler's
    state equal the JAX run's exactly: the floats come from the same
    integers through the same numpy arithmetic."""
    jstore, jmgr, _ = golden.run_scenario()
    tstore, tmgr, _ = _port_scenario()
    assert len(tmgr.reports) == len(jmgr.reports) > 0
    for t, j in zip(tmgr.reports, jmgr.reports):
        assert t.nvm.to_dict() == j.nvm.to_dict()
        assert t.migrations.to_dict() == j.migrations.to_dict()
        assert (t.n_marked, t.tier_pages, t.bank_imbalance) == \
            (j.n_marked, j.tier_pages, j.bank_imbalance)
    assert vars(tstore.leveler.stats) == vars(jstore.leveler.stats)
    assert tstore.leveler._pending == jstore.leveler._pending
    tstore.wear.check()


# =============================================================================
# host policy: placement and allocation
# =============================================================================

def _summaries(n_pages, seed, n_passes=4):
    """Matching (port, JAX) pass summaries from one random event stream,
    as numpy."""
    rng = np.random.RandomState(seed)
    js = jsysmon.init(n_pages, 4, 4)
    ts = sysmon.init(n_pages, 4, 4, device="cpu")
    out = []
    for _ in range(n_passes):
        for _ in range(6):
            ids = rng.randint(0, n_pages, size=n_pages).astype(np.int32)
            w = rng.rand(n_pages) < 0.4
            js = jsysmon.record(js, jnp.asarray(ids), is_write=jnp.asarray(w))
            ts = sysmon.record(ts, torch.from_numpy(ids),
                               is_write=torch.from_numpy(w))
        js, jsum = jsysmon.end_pass(js)
        ts, tsum = sysmon.end_pass(ts)
        out.append((tsum.numpy(), jax.tree.map(np.asarray, jsum)))
    return out


@pytest.mark.parametrize("kind,max_mig,penalty", [
    ("two", None, 0.0), ("two", 8, 4.0), ("three", 16, 0.0),
    ("three", None, 4.0)])
def test_placement_plans_match_jax(kind, max_mig, penalty):
    n_pages = 96
    if kind == "two":
        th = hierarchy.MemoryHierarchy.two_tier(16, 128)
        jh = jhierarchy.MemoryHierarchy.two_tier(16, 128)
    else:
        th = hierarchy.MemoryHierarchy.three_tier(16, 32, 128)
        jh = jhierarchy.MemoryHierarchy.three_tier(16, 32, 128)
    cur = np.random.RandomState(1).randint(0, th.n_tiers, size=n_pages
                                           ).astype(np.int8)
    for tsum, jsum in _summaries(n_pages, seed=len(kind) + (max_mig or 0)):
        got = placement.plan(tsum, cur.copy(), max_migrations=max_mig,
                             wear_penalty=penalty, hierarchy=th)
        want = jplacement.plan(jsum, cur.copy(), max_migrations=max_mig,
                               wear_penalty=penalty, hierarchy=jh)
        for f in jplacement.PlacementDecision._fields:
            assert_same(getattr(got, f), getattr(want, f))
        assert got.migrate.any()
        bal, jbal = placement.BandwidthBalancer(0.5), \
            jplacement.BandwidthBalancer(0.5)
        assert bal.update(0.9) == jbal.update(0.9)
        assert_same(bal.spill_candidates(tsum.wd_code, tsum.hotness, cur,
                                         n=10),
                    jbal.spill_candidates(jsum.wd_code, jsum.hotness, cur,
                                          n=10))


@pytest.mark.parametrize("n_pages,banks,slabs,seed", [
    (64, 4, 4, 0), (256, 32, 4, 1), (48, 2, 8, 2)])
def test_allocator_slots_match_jax(n_pages, banks, slabs, seed):
    """A random mix of colored, masked, multi-page allocations, frees and
    retirements hands out the same slots in both packages."""
    rng = np.random.RandomState(seed)
    ta = allocator.SubBuddyAllocator(allocator.SubBuddyConfig(
        n_pages, banks, slabs))
    ja = jallocator.SubBuddyAllocator(jallocator.SubBuddyConfig(
        n_pages, banks, slabs))
    live: list[tuple[int, int]] = []
    n_colors = banks * slabs
    for _ in range(300):
        op = rng.rand()
        if op < 0.55:
            order = int(rng.choice([0, 0, 0, 1, 2]))
            color = None if rng.rand() < 0.3 else int(rng.randint(n_colors))
            mask = None if color is None or rng.rand() < 0.5 else \
                int(rng.randint(1, n_colors))
            s = ta.alloc(order, color, mask)
            assert s == ja.alloc(order, color, mask)
            if s is not None:
                live.append((s, order))
        elif op < 0.65:
            n = int(rng.randint(1, 5))
            assert ta.alloc_pages(n) == ja.alloc_pages(n)
        elif op < 0.68 and live:
            s, order = live.pop(int(rng.randint(len(live))))
            if order == 0:
                assert ta.retire(s) == ja.retire(s)
            else:
                ta.free(s, order)
                ja.free(s, order)
        elif live:
            s, order = live.pop(int(rng.randint(len(live))))
            ta.free(s, order)
            ja.free(s, order)
        assert ta.n_free == ja.n_free
    ta.check_consistency()


# =============================================================================
# batched migration, wear and energy
# =============================================================================

@pytest.mark.parametrize("kind", ["locked", "optimistic"])
def test_migration_plans_and_target_colors_match_jax(kind):
    """Algorithm-2 slot reservation from the same bank/slab frequencies
    and reuse classes: every planned page, source, destination slot and
    recorded allocator call equal the JAX plan's."""
    rng = np.random.RandomState(11)
    n = 40
    kw = dict(n_pages=n, fast_slots=32, slow_slots=64, page_shape=(2,),
              n_banks=4, n_slabs=4)
    ts = tiers.TierStore(tiers.TierConfig(**kw), device="cpu")
    js = jtiers.TierStore(jtiers.TierConfig(**kw))
    for p in range(n):
        t = int(p % 3 == 0)
        assert ts.allocate(p, t) and js.allocate(p, t)
    bank = rng.randint(0, 50, size=4)
    slab = rng.randint(0, 50, size=4)
    reuse = rng.randint(0, 3, size=n).astype(np.int8)
    for rc in (None, 0, 1, 2):
        assert migration.target_color(ts, 1, bank, slab, rc) == \
            jmigration.target_color(js, 1, bank, slab, rc)
    pages = list(rng.permutation(n)[:25]) + [3, 3]
    fn = {"locked": (migration.plan_locked, jmigration.plan_locked),
          "optimistic": (migration.plan_optimistic,
                         jmigration.plan_optimistic)}[kind]
    for dst in (0, 1):
        got = fn[0](ts, pages, dst, bank, slab, reuse)
        want = fn[1](js, pages, dst, bank, slab, reuse)
        for f in ("pages", "src_tiers", "src_slots", "dst_slots", "colors",
                  "masks"):
            assert_same(getattr(got, f), getattr(want, f))
        assert (got.dst_tier, got.trivial, got.reads_by_tier) == \
            (want.dst_tier, want.trivial, want.reads_by_tier)
        assert len(got) > 0

def _stores(dtype_t, dtype_j, n_pages=24, fast=8, slow=32, interval=3):
    kw = dict(n_pages=n_pages, fast_slots=fast, slow_slots=slow,
              page_shape=(2, 3, 8), n_banks=2, n_slabs=2,
              gap_write_interval=interval)
    return (tiers.TierStore(tiers.TierConfig(dtype=dtype_t, **kw),
                            device="cpu"),
            jtiers.TierStore(jtiers.TierConfig(dtype=dtype_j, **kw)))


@pytest.mark.parametrize("dtype_t,dtype_j", [
    (torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)])
def test_batched_migration_round_trip_matches_jax(dtype_t, dtype_j):
    """Pages written to the slow tier, promoted (locked), written to and
    demoted (optimistic) in bulk: page tables, traffic, wear, the
    leveler's remap, the host pool's stored bits (bfloat16 as uint16) and
    the device pool match the JAX store exactly."""
    ts, js = _stores(dtype_t, dtype_j)
    te, je = migration.BatchedMigrationEngine(ts), \
        jmigration.BatchedMigrationEngine(js)
    rng = np.random.RandomState(3)
    slow = int(ts.tier[0])
    for p in range(ts.cfg.n_pages):
        assert ts.allocate(p, slow) and js.allocate(p, slow)
        v = rng.standard_normal((2, 3, 8)).astype(np.float32)
        ts.write_page(p, v)
        js.write_page(p, v)
    up = rng.permutation(ts.cfg.n_pages)[:7]
    assert te.migrate_locked(up, 0).to_dict() == \
        je.migrate_locked(up, 0).to_dict()
    for p in up[:3]:
        v = rng.standard_normal((2, 3, 8)).astype(np.float32)
        ts.write_page(int(p), v)
        js.write_page(int(p), v)
    down = up[1:6]
    assert te.migrate_optimistic(down, slow).to_dict() == \
        je.migrate_optimistic(down, slow).to_dict()
    assert te.stats.to_dict() == je.stats.to_dict()
    for f in ("tier", "slot", "version"):
        assert_same(getattr(ts, f), getattr(js, f))
    assert ts.traffic == js.traffic
    assert (ts.writes_to, ts.reads_from) == (js.writes_to, js.reads_from)
    jfast = np.asarray(js.fast_pool)
    if dtype_t == torch.bfloat16:
        assert_same(ts.fast_pool.view(torch.int16).numpy().view(np.uint16),
                    jfast.view(np.uint16))
    else:
        assert_same(ts.fast_pool, jfast)
    assert_same(ts.pools[slow].data, np.asarray(js.pools[slow].data))
    for p in range(ts.cfg.n_pages):
        assert_same(ts.read_page(p), js.read_page(p))
    assert_same(ts.wear.wear_counts(), js.wear.wear_counts())
    assert_same(ts.wear._remap, js.wear._remap)
    assert_same(ts.wear.state.remap, js.wear.state.remap)
    assert ts.wear.leveling_writes == js.wear.leveling_writes > 0
    ts.wear.check()


def test_energy_meter_and_lifetime_match_jax():
    """Energy windows over host writes and reads, with Start-Gap rotating
    the pool: every NvmReport and the live lifetime projection are equal."""
    ts, js = _stores(torch.float32, jnp.float32, n_pages=20, fast=4,
                     slow=20, interval=2)
    tm, jm = energy.EnergyMeter(ts), jenergy.EnergyMeter(js)
    rng = np.random.RandomState(8)
    slow = int(ts.tier[0])
    for p in range(20):
        ts.allocate(p, slow)
        js.allocate(p, slow)
    for window in (0.5, 1.0, 2.0):
        for p in rng.randint(0, 20, size=15):
            v = np.full((2, 3, 8), float(p), np.float32)
            ts.write_page(int(p), v)
            js.write_page(int(p), v)
            assert_same(ts.read_page(int(p)), js.read_page(int(p)))
        assert tm.project_lifetime() == jm.project_lifetime()
        assert tm.end_pass(window).to_dict() == jm.end_pass(window).to_dict()
    assert_same(ts.wear.wear_counts(), js.wear.wear_counts())
    assert_same(ts.wear._remap, js.wear._remap)
