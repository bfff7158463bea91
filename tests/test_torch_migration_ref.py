"""The port's per-page reference migration engine against the JAX one.

Twins of ``tests/test_migration_tiers.py`` (and the reference half of
``tests/test_batched_migration.py``): ``TierStore.move_page``,
and ``MigrationEngine`` on the port's stores (CPU
tensors) and on the JAX numpy-host stores, from the same pages and
calls.  Page tables, versions, traffic, allocator bookkeeping and every
page's bytes must match exactly — float32, bfloat16 and the int8 tier
alike — and the reference engine must land every page where the port's
batched engine does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.memos_pair import alloc_state
from helpers.torch_parity import cap_threads
from repro.core import migration as jmigration
from repro.core import tiers as jtiers
from repro.core.memos import MemosConfig as JMemosConfig
from repro.core.memos import MemosManager as JMemosManager
from repro.core import sysmon as jsysmon
from repro_torch.core import migration, sysmon, tiers
from repro_torch.core.hierarchy import FAST, SLOW, MemoryHierarchy
from repro_torch.core.memos import MemosConfig, MemosManager

cap_threads()

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def make_pair(n=32, fast=16, slow=64, quantize=False, dtype="float32",
              fill="index"):
    """(port store, JAX store), every page in the slow tier, written with
    its index (``fill="index"``, as ``test_migration_tiers.py``) or
    seeded normals."""
    tdt, jdt = DTYPES[dtype]
    t = tiers.TierStore(tiers.StoreConfig(
        n_pages=n, page_shape=(4,), dtype=tdt,
        hierarchy=MemoryHierarchy.two_tier(fast, slow,
                                           quantize_slow=quantize)),
        device="cpu")
    j = jtiers.TierStore(jtiers.TierConfig(
        n_pages=n, fast_slots=fast, slow_slots=slow, page_shape=(4,),
        dtype=jdt, quantize_slow=quantize))
    rng = np.random.RandomState(0)
    for p in range(n):
        v = (np.full(4, float(p), np.float32) if fill == "index"
             else rng.standard_normal(4).astype(np.float32))
        for s in (t, j):
            assert s.allocate(p, SLOW)
            s.write_page(p, v)
    return t, j


def peek(s, page):
    """A page's contents without charging the read to the store."""
    reads = dict(s.reads_from)
    v = s.read_page(page)
    s.reads_from.update(reads)
    return v


def assert_pair(t, j):
    for f in ("tier", "slot", "version"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
    assert t.traffic == j.traffic
    assert (t.writes_to, t.reads_from) == (j.writes_to, j.reads_from)
    assert [alloc_state(a) for a in t.alloc] == \
        [alloc_state(a) for a in j.alloc]
    for p in np.nonzero(t.slot != -1)[0]:
        np.testing.assert_array_equal(peek(t, int(p)), peek(j, int(p)),
                                      f"page {p}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_move_preserves_contents_bitexact(dtype):
    t, j = make_pair(dtype=dtype, fill="normal")
    want = {p: peek(t, p) for p in range(8)}
    for eng in (migration.MigrationEngine(t), jmigration.MigrationEngine(j)):
        eng.migrate_locked(range(8), FAST)
    for p in range(8):
        assert t.tier[p] == FAST
        np.testing.assert_array_equal(peek(t, p), want[p])
    assert_pair(t, j)
    for eng in (migration.MigrationEngine(t), jmigration.MigrationEngine(j)):
        eng.migrate_locked(range(8), SLOW)
    for p in range(8):
        assert t.tier[p] == SLOW
        np.testing.assert_array_equal(peek(t, p), want[p])
    assert_pair(t, j)


def test_move_page_primitive_matches_jax():
    """``move_page`` between the tiers, with a color, onto a full tier
    and for a released page: the same result, slot and traffic as the
    JAX store's."""
    t, j = make_pair(fast=4, fill="normal")
    for s in (t, j):
        assert s.move_page(3, FAST, color=1, color_mask=1)
        assert s.move_page(3, FAST)               # already there: no-op
        for p in (4, 5, 6):
            assert s.move_page(p, FAST)
        assert not s.move_page(7, FAST)           # the tier is full
        s.release(9)
        assert not s.move_page(9, FAST)           # released: nothing to move
        assert s.move_page(3, SLOW)
    assert_pair(t, j)


def test_optimistic_discards_dirty_pages():
    t, j = make_pair()
    got = []
    for s, mig in ((t, migration), (j, jmigration)):
        eng = mig.MigrationEngine(s, max_retries=0)
        st = eng.migrate_optimistic(
            [0, 1, 2], FAST,
            concurrent_writer=lambda s=s: s.write_page(
                1, np.zeros(4, np.float32)))
        got.append(st.to_dict())
    assert got[0] == got[1] and got[0]["dirty_discards"] == 1
    assert t.tier[0] == FAST and t.tier[2] == FAST and t.tier[1] == SLOW
    np.testing.assert_array_equal(peek(t, 1), np.zeros(4))
    assert_pair(t, j)


def test_optimistic_retries_dirty_pages():
    t, j = make_pair()
    for s, mig in ((t, migration), (j, jmigration)):
        eng = mig.MigrationEngine(s, max_retries=2, retry_backoff_s=1e-6)
        st = eng.migrate_optimistic(
            [0, 1], FAST, concurrent_writer=lambda s=s: s.write_page(
                1, np.full(4, 42.0, np.float32)))
        assert st.migrated == 2 and st.retries == 1
    assert t.tier[1] == FAST
    np.testing.assert_array_equal(peek(t, 1), np.full(4, 42.0))
    assert_pair(t, j)


@pytest.mark.parametrize("seed", range(6))
def test_migration_conservation(seed):
    """Random page sets either way: every page stays allocated exactly
    once, contents survive, and the port equals JAX."""
    rng = np.random.RandomState(seed)
    pages = rng.choice(32, size=rng.randint(1, 33), replace=False).tolist()
    to_fast = bool(rng.randint(2))
    t, j = make_pair()
    dst = FAST if to_fast else SLOW
    migration.MigrationEngine(t).migrate_locked(pages, dst)
    jmigration.MigrationEngine(j).migrate_locked(pages, dst)
    assert (t.slot != -1).all()
    assert len({(int(t.tier[p]), int(t.slot[p])) for p in range(32)}) == 32
    for p in range(32):
        np.testing.assert_array_equal(peek(t, p), np.full(4, float(p)))
    assert_pair(t, j)


def test_quantized_slow_tier_roundtrip():
    """The int8 host tier: lossy but bounded, and the port's per-page
    quantizer gives the JAX tier's bytes, through ``move_page`` too."""
    t, j = make_pair(quantize=True)
    data = np.linspace(-1, 1, 4).astype(np.float32)
    for s in (t, j):
        s.write_page(3, data)
    out = peek(t, 3)
    assert np.max(np.abs(out - data)) < 1.0 / 127 + 1e-6
    np.testing.assert_array_equal(t.pools[1].data, j.pools[1].data)
    np.testing.assert_array_equal(t.pools[1].scale, j.pools[1].scale)
    for s, mig in ((t, migration), (j, jmigration)):
        mig.MigrationEngine(s).migrate_locked([3, 4], FAST)
        mig.MigrationEngine(s).migrate_optimistic([3, 4], SLOW)
    assert_pair(t, j)
    np.testing.assert_array_equal(t.pools[1].data, j.pools[1].data)
    np.testing.assert_array_equal(t.pools[1].scale, j.pools[1].scale)


def test_capacity_bound_respected():
    t, j = make_pair(fast=4)
    st = migration.MigrationEngine(t).migrate_locked(range(32), FAST)
    jst = jmigration.MigrationEngine(j).migrate_locked(range(32), FAST)
    assert st.to_dict() == jst.to_dict() and st.migrated <= 4
    assert (t.tier == FAST).sum() <= 4
    assert_pair(t, j)


def test_memos_loop_moves_hot_to_fast_and_cold_back():
    """The memos loop on the reference engine (set on the port's
    manager, ``MemosConfig(engine="reference")`` in JAX): hot pages
    promoted, cold ones drained back, contents intact, pass for pass as
    in JAX."""
    t, j = make_pair(fast=8)
    mgr = MemosManager(t, MemosConfig(interval=1, adaptive_interval=False))
    mgr.engine = migration.MigrationEngine(t)
    jmgr = JMemosManager(j, JMemosConfig(interval=1, adaptive_interval=False,
                                         engine="reference"))
    sm = sysmon.init(32, 4, 4, device="cpu")
    jsm = jsysmon.init(32, 4, 4)

    def hot(ids, n=8):
        nonlocal sm, jsm
        for _ in range(n):
            sm = sysmon.record(sm, torch.arange(*ids, dtype=torch.int32),
                               is_write=True)
            jsm = jsysmon.record(jsm, jnp.arange(*ids), is_write=True)
        sm, _ = mgr.maybe_step(sm)
        jsm, _ = jmgr.maybe_step(jsm)
        np.testing.assert_array_equal(t.tier, j.tier)

    hot((0, 4))
    assert all(t.tier[p] == FAST for p in range(4))
    for _ in range(10):
        hot((8, 12))
    assert all(t.tier[p] == FAST for p in range(8, 12))
    assert all(t.tier[p] == SLOW for p in range(4))
    for p in range(32):
        np.testing.assert_array_equal(peek(t, p), np.full(4, float(p)))
    assert [r.migrations.to_dict() for r in mgr.reports] == \
        [r.migrations.to_dict() for r in jmgr.reports]
    assert_pair(t, j)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("locked", [True, False])
def test_reference_engine_matches_batched_engine(locked, quantize):
    """The oracle's use: on the same port store the per-page engine and
    the bulk engine give the same page table, traffic and bytes, on a
    float32 slow tier and on an int8 one."""
    a, _ = make_pair(fill="normal", quantize=quantize)
    b, _ = make_pair(fill="normal", quantize=quantize)
    rng = np.random.RandomState(3)
    for _ in range(3):
        pages = rng.choice(32, size=10, replace=False).tolist()
        dst = int(rng.randint(2))
        for s, engine in ((a, migration.MigrationEngine),
                          (b, migration.BatchedMigrationEngine)):
            eng = engine(s)
            (eng.migrate_locked if locked else eng.migrate_optimistic)(
                pages, dst, np.ones(4), np.ones(4))
    for f in ("tier", "slot", "version"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert a.traffic == b.traffic
    for p in range(32):
        np.testing.assert_array_equal(peek(a, p), peek(b, p))

