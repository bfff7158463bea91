"""The int8 soft-NVM tiers of the port against the JAX package.

* Kernel K6's plain version (``page_gather_quant_plain``) against the
  numpy host quantizer (exact) and the Pallas kernel in interpret mode.
  XLA on this host divides by the constant 127 as a product with its
  reciprocal, so the Pallas scale may sit one float32 ulp off the
  numpy one (ROADMAP C4): against it the scale is held to rtol 2**-23
  and q to +-1, and exactly where the two scales agree.
* ``dequant_gather``'s plain version against ``page_gather_dequant_ref``.
* The port's int8 stores — numpy host and pinned — against the JAX
  numpy-host int8 store (the JAX pinned pool aborts on this CPU,
  ROADMAP C1) after the same writes, promotions, demotions and Start-Gap
  advances: int8 bytes, scales, wear, remap and page table exactly.
* Checksums, flips and quarantine on int8 pages, against the JAX
  numpy-host int8 store.
* The port engine over an int8 host tier against the JAX engine with
  memos migrating, and the port's pinned int8 engine against its numpy
  int8 engine.
* ``requires_cuda``: K6, ``dequant_gather`` and the 1-byte K5 against
  their plain versions on the card.  They need no JAX, so they also run
  on a CUDA host without it, where every other case skips.
"""
import numpy as np
import pytest
import torch

from helpers.torch_parity import (assert_close, assert_same, cap_threads,
                                  cuda_device)

try:
    import jax
    import jax.numpy as jnp

    from repro import faults as jfaults
    from repro import obs as jobs
    from repro.configs import registry as jregistry
    from repro.configs import smoke as jsmoke
    from repro.core import hierarchy as jhierarchy
    from repro.core import migration as jmigration
    from repro.core import tiers as jtiers
    from repro.kernels.page_gather.page_gather import \
        page_gather_quant_pallas
    from repro.kernels.page_gather.ref import page_gather_dequant_ref
    from repro.models import transformer as JT
    from repro.serving import PagedServingEngine as JEngine
    from repro.serving import ServeConfig as JServeConfig
    HAVE_JAX = True
except ImportError:        # a CUDA host without JAX: the card cases only
    HAVE_JAX = False
from repro_torch import faults, kernels, obs
from repro_torch.configs.base import registry, smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import migration, tiers
from repro_torch.core.hierarchy import MemoryHierarchy
from repro_torch.faults import FaultConfig, FaultInjector
from repro_torch.kernels import page_checksum as K5
from repro_torch.kernels import page_quant as K6
from repro_torch.serving.engine import PagedServingEngine, ServeConfig

cap_threads()

SEED = 0


@pytest.fixture(autouse=True)
def _clean_global_state(request):
    if not HAVE_JAX and request.node.get_closest_marker(
            "requires_cuda") is None:
        pytest.skip("compares with the JAX package, which is not installed")
    mods = (faults, obs) + ((jfaults, jobs) if HAVE_JAX else ())
    for m in mods:
        m.reset()
    yield
    for m in mods:
        m.reset()


def _np_quantize(pages: np.ndarray):
    """The JAX host tier's batch quantizer (``HostPool.write_batch``)."""
    axes = tuple(range(1, pages.ndim))
    scale = np.maximum(np.max(np.abs(pages), axis=axes), 1e-8) / 127.0
    b = scale.reshape((-1,) + (1,) * (pages.ndim - 1))
    return (np.clip(np.round(pages / b), -127, 127).astype(np.int8),
            scale.astype(np.float32))


# =============================================================================
# the kernels' plain versions
# =============================================================================

@pytest.mark.parametrize("n_slots,k,shape", [(32, 4, (8, 4)), (16, 8, (4,)),
                                             (12, 5, (2, 3, 16))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_page_gather_quant_plain_matches_numpy_and_pallas(n_slots, k, shape,
                                                          dtype):
    rng = np.random.RandomState(6)
    pool = torch.from_numpy((rng.standard_normal((n_slots, *shape)) * 3.0)
                            .astype(np.float32)).to(dtype)
    idx = rng.permutation(n_slots)[:k].astype(np.int32)
    q, s = K6.page_gather_quant(pool, torch.from_numpy(idx))
    qn, sn = _np_quantize(pool.float().numpy()[idx])
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert_same(q, qn)
    assert_same(s, sn)
    qp, sp = page_gather_quant_pallas(jnp.asarray(pool.float().numpy()),
                                      jnp.asarray(idx), interpret=True)
    qp, sp = np.asarray(qp), np.asarray(sp)
    np.testing.assert_allclose(s.numpy(), sp, rtol=2.0 ** -23, atol=0)
    same = s.numpy() == sp
    assert_same(q.numpy()[same], qp[same])
    assert np.abs(q.numpy().astype(np.int32) - qp).max() <= 1


def test_quantize_rounds_half_to_even_with_ieee_division():
    """absmax 127 gives scale 1.0 exactly, so x/scale lands on .5 ties:
    the plain version rounds them to even, like np.round."""
    page = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]],
                    np.float32)
    q, s = K6.quantize_pages_plain(torch.from_numpy(page))
    assert float(s[0]) == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, -2, 126]]
    assert_same(q, _np_quantize(page)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequant_gather_plain_matches_jax_ref(dtype):
    rng = np.random.RandomState(8)
    pq = rng.randint(-127, 128, size=(10, 4, 6)).astype(np.int8)
    ps = (rng.rand(10) * 0.05 + 1e-3).astype(np.float32)
    idx = np.array([3, 9, 0, 3], np.int32)
    got = K6.dequant_gather(torch.from_numpy(pq), torch.from_numpy(ps),
                            torch.from_numpy(idx), dtype)
    want = np.array(page_gather_dequant_ref(jnp.asarray(pq),
                                            jnp.asarray(ps),
                                            jnp.asarray(idx)))
    assert got.dtype == dtype
    assert_same(got.float(), torch.from_numpy(want).to(dtype).float())


def test_int8_wrappers_on_cpu_never_launch():
    kernels.reset_launch_counts()
    pool = torch.randn(4, 8)
    q, s = K6.page_gather_quant(pool, torch.tensor([1, 2], dtype=torch.int32))
    K6.dequant_gather(q, s, torch.tensor([0], dtype=torch.int32),
                      torch.float32)
    counts = kernels.launch_counts()
    assert counts["page_gather_quant"] == counts["dequant_gather"] == 0


# =============================================================================
# the int8 stores against the JAX numpy-host int8 store
# =============================================================================

def _int8_hier(kind, pinned, port=True, gap=3):
    kw = dict(gap_write_interval=gap)
    if port:
        kw["pinned_slow" if kind == "two" else "pinned_nvm"] = pinned
    H = MemoryHierarchy if port else jhierarchy.MemoryHierarchy
    if kind == "two":
        return H.two_tier(6, 16, quantize_slow=True, **kw)
    return H.three_tier(4, 6, 16, quantize_nvm=True, **kw)


def _int8_stores(kind, pinned, dtype):
    shape = (3, 4)
    ts = tiers.TierStore(tiers.StoreConfig(
        n_pages=16, page_shape=shape, dtype=getattr(torch, dtype),
        hierarchy=_int8_hier(kind, pinned)), device="cpu")
    js = jtiers.TierStore(jtiers.StoreConfig(
        n_pages=16, page_shape=shape, dtype=getattr(jnp, dtype),
        hierarchy=_int8_hier(kind, pinned, port=False)))
    return ts, js


def _int8_raw(store, t):
    pool = store.pools[t]
    if isinstance(pool.data, np.ndarray):
        return pool.data, pool.scale
    return pool.raw(), pool.scale.numpy()


def _assert_int8_stores_match(ts, js):
    for f in ("tier", "slot", "version"):
        assert_same(getattr(ts, f), getattr(js, f))
    assert ts.traffic == js.traffic
    assert (ts.writes_to, ts.reads_from) == (js.writes_to, js.reads_from)
    t = ts.hierarchy.deepest
    q, s = _int8_raw(ts, t)
    assert q.dtype == np.int8
    assert_same(q, js.pools[t].data)
    assert_same(s, js.pools[t].scale)
    tw, jw = ts.wear_by_tier[t], js.wear_by_tier[t]
    assert_same(tw.wear_counts(), jw.wear_counts())
    assert_same(tw._remap, jw._remap)
    assert vars(ts.leveler_by_tier[t].stats) == \
        vars(js.leveler_by_tier[t].stats)
    for d in ts.hierarchy.device_tiers():
        got = ts.pools[d].data.float().numpy()
        assert_same(got, np.asarray(js.pools[d].data, np.float32))
    for p in range(ts.cfg.n_pages):
        assert_same(ts.read_page(p), js.read_page(p))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pinned", [False, True])
def test_int8_store_matches_jax_host_store(pinned, dtype):
    """Twin of ``test_hierarchy.py::test_quantized_slow_tier_roundtrip``:
    pages written to the int8 tier, promoted (dequantized), rewritten and
    demoted (quantized by K6's plain version), with Start-Gap rotating
    the int8 rows and their scales."""
    ts, js = _int8_stores("two", pinned, dtype)
    pool_cls = tiers.PinnedHostPool if pinned else tiers.HostPool
    assert isinstance(ts.pools[1], pool_cls) and ts.pools[1].quantized
    te = migration.BatchedMigrationEngine(ts, chunk_pages=3)
    je = jmigration.BatchedMigrationEngine(js, chunk_pages=3)
    rng = np.random.RandomState(1)
    for p in range(16):
        for s in (ts, js):
            assert s.allocate(p, 1)
        v = (rng.standard_normal((3, 4)) * 2).astype(np.float32)
        ts.write_page(p, v)
        js.write_page(p, v)
    for pages, dst, locked in (([3, 1, 7, 9, 12], 0, True),
                               ([1, 7], 1, False),
                               ([0, 2, 4, 6, 8, 10], 0, True),
                               ([3, 12, 4, 8], 1, False),
                               ([9, 0], 1, True)):
        for p in pages[:2]:
            if int(ts.tier[p]) == 0:        # dirty a resident page first
                v = rng.standard_normal((3, 4)).astype(np.float32)
                ts.write_page(p, v)
                js.write_page(p, v)
        a = (te.migrate_locked if locked else te.migrate_optimistic)(
            pages, dst)
        b = (je.migrate_locked if locked else je.migrate_optimistic)(
            pages, dst)
        assert a.to_dict() == b.to_dict()
    assert ts.leveler_by_tier[1].stats.advances > 0
    assert ts.traffic[(0, 1)] > 0 and ts.traffic[(1, 0)] > 0
    _assert_int8_stores_match(ts, js)


@pytest.mark.parametrize("pinned", [False, True])
def test_int8_three_tier_moves_match_jax(pinned):
    """Twin of ``test_three_tier_moves_preserve_contents[True]``: pages
    walk NVM(int8) -> HBM -> DRAM -> NVM -> DRAM -> HBM; the port matches
    the JAX numpy-host int8 store exactly and the contents stay within
    two quantization steps of the originals."""
    ts, js = _int8_stores("three", pinned, "float32")
    te = migration.BatchedMigrationEngine(ts, chunk_pages=3)
    je = jmigration.BatchedMigrationEngine(js, chunk_pages=3)
    rng = np.random.RandomState(2)
    for p in range(16):
        for s in (ts, js):
            assert s.allocate(p, 2)
        v = rng.standard_normal((3, 4)).astype(np.float32)
        ts.write_page(p, v)
        js.write_page(p, v)
    expect = {p: ts.read_page(p).copy() for p in range(16)}
    for p in range(16):
        assert_same(js.read_page(p), expect[p])
    for pages, dst in ([range(8), 0], [range(4), 1], [range(4), 2],
                       [range(2), 1], [range(2), 0]):
        assert te.migrate_locked(pages, dst).to_dict() == \
            je.migrate_locked(pages, dst).to_dict()
    for pair in [(2, 0), (0, 1), (1, 2), (2, 1), (1, 0)]:
        assert ts.traffic[pair] > 0, f"no traffic across {pair}"
    _assert_int8_stores_match(ts, js)
    for p in range(16):
        scale = np.abs(expect[p]).max() / 127
        np.testing.assert_allclose(ts.read_page(p), expect[p],
                                   atol=2 * scale + 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pinned", [False, True])
def test_int8_tier_beside_numpy_host_tier_matches_jax(pinned, dtype):
    """DRAM as a numpy host tier beside the int8 NVM tier: pages cross
    between them host to host (or host to pinned) and are quantized or
    dequantized in numpy on the way, as the JAX numpy-host store's
    ``host_read_batch``/``host_write_batch`` do; locked and optimistic
    moves match the JAX store byte for byte."""
    shape = (3, 4)
    ts = tiers.TierStore(tiers.StoreConfig(
        n_pages=16, page_shape=shape, dtype=getattr(torch, dtype),
        hierarchy=MemoryHierarchy.three_tier(
            4, 6, 16, quantize_nvm=True, gap_write_interval=3,
            pinned_nvm=pinned).with_tier(1, residency="host")),
        device="cpu")
    js = jtiers.TierStore(jtiers.StoreConfig(
        n_pages=16, page_shape=shape, dtype=getattr(jnp, dtype),
        hierarchy=jhierarchy.MemoryHierarchy.three_tier(
            4, 6, 16, quantize_nvm=True, gap_write_interval=3).with_tier(
                1, residency="host")))
    assert not ts.is_addressable_tier(1) and ts.pools[2].quantized
    te = migration.BatchedMigrationEngine(ts, chunk_pages=3)
    je = jmigration.BatchedMigrationEngine(js, chunk_pages=3)
    rng = np.random.RandomState(3)
    for p in range(16):
        for s in (ts, js):
            assert s.allocate(p, 2)
        v = rng.standard_normal(shape).astype(np.float32)
        ts.write_page(p, v)
        js.write_page(p, v)
    for pages, dst, locked in (([8, 9, 10, 11], 1, True),     # NVM -> DRAM
                               ([8, 9], 2, False),            # DRAM -> NVM
                               ([0, 1, 2], 0, True),          # NVM -> HBM
                               ([0, 1], 1, True),             # HBM -> DRAM
                               ([10, 11, 0], 2, True),        # DRAM -> NVM
                               ([12, 13, 14], 1, False),      # NVM -> DRAM
                               ([1, 12], 0, False)):          # DRAM -> HBM
        a = (te.migrate_locked if locked else te.migrate_optimistic)(
            pages, dst)
        b = (je.migrate_locked if locked else je.migrate_optimistic)(
            pages, dst)
        assert a.to_dict() == b.to_dict()
    for pair in [(2, 1), (1, 2), (2, 0), (0, 1), (1, 0)]:
        assert ts.traffic[pair] > 0, f"no traffic across {pair}"
    _assert_int8_stores_match(ts, js)
    assert_same(ts.pools[1].data, js.pools[1].data)


# =============================================================================
# checksums, flips and quarantine on int8 pages
# =============================================================================

def _faulty_int8_store(pinned, seed, port=True):
    (faults if port else jfaults).configure(
        (FaultConfig if port else jfaults.FaultConfig)(seed=seed))
    if port:
        store = tiers.TierStore(tiers.StoreConfig(
            n_pages=32, page_shape=(8,), n_banks=2, n_slabs=4,
            hierarchy=MemoryHierarchy.two_tier(
                8, 32, pinned_slow=pinned, quantize_slow=True,
                gap_write_interval=5)), device="cpu")
    else:
        store = jtiers.TierStore(jtiers.StoreConfig(
            n_pages=32, page_shape=(8,), n_banks=2, n_slabs=4,
            hierarchy=jhierarchy.MemoryHierarchy.two_tier(
                8, 32, quantize_slow=True, gap_write_interval=5)))
    rng = np.random.RandomState(seed)
    for p in range(32):
        assert store.allocate(p, int(store.tier[p]))
        store.write_page(p, rng.standard_normal(8).astype(np.float32))
    return store


@pytest.mark.parametrize("pinned", [False, True])
def test_int8_checksum_catches_every_flip(pinned):
    """Twin of ``test_checksum_catches_every_flip_pinned_pool[True]``:
    int8 pages are summed over their stored bytes (K5's 1-byte case on
    the pinned pool), the records equal the JAX host store's, and every
    single-bit flip of a row is caught and undone cleanly."""
    store = _faulty_int8_store(pinned, seed=3)
    jstore = _faulty_int8_store(pinned, seed=3, port=False)
    assert store.integrity.sums == jstore.integrity.sums
    t = store.hierarchy.deepest
    live = np.nonzero((store.tier == t) & (store.slot != -1))[0]
    slots = [int(store.slot[p]) for p in live]
    assert slots and store.integrity.verify(store, t, slots) == []
    raw = store.pools[t].raw()
    assert raw.dtype == np.int8
    row_bytes = FaultInjector._row_bytes(raw)
    rng = np.random.RandomState(9)
    for _ in range(12):
        s = int(rng.choice(slots))
        phys = int(store._phys(t, np.asarray([s]))[0])
        byte, bit = int(rng.randint(row_bytes)), int(rng.randint(8))
        FaultInjector._xor_bit(raw, phys, byte, bit)
        assert store.integrity.verify(store, t, slots) == [s]
        FaultInjector._xor_bit(raw, phys, byte, bit)
        assert store.integrity.verify(store, t, slots) == []


@pytest.mark.parametrize("pinned", [False, True])
def test_int8_injector_and_quarantine_match_jax(pinned):
    """The same seed over the same int8 store state flips the same bits
    as the JAX injector over its numpy-host int8 store, the same slots
    fail verification and are quarantined, and their pages are unbound
    the same way."""
    store = _faulty_int8_store(pinned, seed=4)
    jstore = _faulty_int8_store(pinned, seed=4, port=False)
    cfg = dict(seed=11, media_flip_rate=0.05)
    inj = faults.configure(FaultConfig(**cfg))
    jinj = jfaults.configure(jfaults.FaultConfig(**cfg))
    for _ in range(6):
        inj.tick(store)
        jinj.tick(jstore)
    assert inj.total_injected == jinj.total_injected > 0
    t = store.hierarchy.deepest
    assert_same(store.pools[t].raw(), jstore.pools[t].data)
    slots = sorted({int(s) for s in store.slot[store.tier == t] if s >= 0})
    bad = store.integrity.verify(store, t, slots)
    assert bad == jstore.integrity.verify(jstore, t, slots) != []
    for s in bad:
        assert store.quarantine_slot(t, s, "test") == \
            jstore.quarantine_slot(t, s, "test")
    assert store.quarantined == jstore.quarantined
    assert store.quarantine_log == jstore.quarantine_log
    assert_same(store.slot, jstore.slot)


# =============================================================================
# the engine over int8 tiers
# =============================================================================

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


# 8 HBM slots for three concurrent sequences: preemption, quantized
# demotion and dequantized promotion all happen
SCFG = dict(page_size=8, max_batch=3, fast_slots=8, slow_slots=128,
            memos_interval=8, decode_block=8)
SYSMON_FIELDS = ("reads", "writes", "access_count", "hist", "last_access",
                 "intv_cnt", "intv_sum", "intv_sqsum", "bank_freq",
                 "slab_freq", "page_bank", "page_slab", "sample_idx")


def _port_engine(models, prompts, **kw):
    tcfg, tparams, _, _ = models
    eng = PagedServingEngine(tcfg, tparams, ServeConfig(**{**SCFG, **kw}),
                             device="cpu")
    reqs = [eng.submit(p, 16) for p in prompts]
    eng.run(max_steps=600)
    assert eng.batcher.all_done()
    return eng, reqs


def test_int8_host_engine_matches_jax(models):
    """The port over ``two_tier(8, 128, quantize_slow=True)`` against the
    JAX engine over the same hierarchy, memos migrating: identical
    tokens, SysMon, page table, traffic, wear and migration stats.  The
    int8 bytes agree to +-1 and the scales to the float tolerance: the
    K/V values they quantize come from XLA and torch matmuls that sum in
    different orders."""
    tcfg, tparams, jcfg, jparams = models
    prompts = _prompts(tcfg.vocab)
    hier = dict(quantize_slow=True)
    jeng = JEngine(jcfg, jparams, JServeConfig(
        **SCFG, hierarchy=jhierarchy.MemoryHierarchy.two_tier(8, 128,
                                                              **hier)))
    jreqs = [jeng.submit(p, 16) for p in prompts]
    jeng.run(max_steps=600)
    teng, treqs = _port_engine(models, prompts,
                               hierarchy=MemoryHierarchy.two_tier(8, 128,
                                                                  **hier))
    for j, t in zip(jreqs, treqs):
        assert t.generated == j.generated and t.error is None
    for f in SYSMON_FIELDS:
        assert_same(getattr(teng.sysmon, f), getattr(jeng.sysmon, f))
    ts, js = teng.kv.store, jeng.kv.store
    for f in ("tier", "slot", "version"):
        assert_same(getattr(ts, f), getattr(js, f))
    assert ts.traffic == js.traffic
    assert ts.traffic[(0, 1)] > 0 and ts.traffic[(1, 0)] > 0
    assert teng.memos.engine.stats.to_dict() == \
        jeng.memos.engine.stats.to_dict()
    assert_same(ts.wear.wear_counts(), js.wear.wear_counts())
    assert ts.wear.writes_total == js.wear.writes_total > 0
    assert_same(ts.wear._remap, js.wear._remap)
    q, jq = ts.pools[1].data.astype(np.int32), js.pools[1].data
    assert np.abs(q - jq).max() <= 1 and (q == jq).mean() > 0.999
    assert_close(ts.pools[1].scale, js.pools[1].scale)


def test_int8_pinned_engine_matches_int8_host_engine(models):
    """The port's pinned int8 tier is promoted before it is attended, as
    its numpy int8 tier is, and both quantize with the same function:
    the two engines emit the same tokens and leave the same int8 bytes
    and scales at every logical slot (through the wear remap)."""
    prompts = _prompts(models[0].vocab)
    runs = {}
    for pinned in (False, True):
        eng, reqs = _port_engine(models, prompts,
                                 hierarchy=MemoryHierarchy.two_tier(
                                     8, 128, pinned_slow=pinned,
                                     quantize_slow=True))
        assert eng.pinned_tier is None           # never served in place
        runs[pinned] = (eng, [r.generated for r in reqs])
    (he, htok), (pe, ptok) = runs[False], runs[True]
    assert htok == ptok
    hs, ps = he.kv.store, pe.kv.store
    for f in ("tier", "slot", "version"):
        assert_same(getattr(hs, f), getattr(ps, f))
    assert hs.traffic == ps.traffic and hs.traffic[(1, 0)] > 0
    logical = np.arange(128)
    hq, hsc = _int8_raw(hs, 1)
    pq, psc = _int8_raw(ps, 1)
    assert_same(hq[hs.wear.phys(logical)], pq[ps.wear.phys(logical)])
    assert_same(hsc[hs.wear.phys(logical)], psc[ps.wear.phys(logical)])
    assert_same(hs.wear.wear_counts(), ps.wear.wear_counts())


# the serving page (36 layers x [2, 16, 8, 128]), smaller aligned pages, a
# page of odd size and the serving page at an unaligned base
K6_PAGES = [(1179648, 2, True), (1179648, 4, True), (65536, 2, True),
            (272, 4, True), (16, 2, True), (1179647, 2, True),
            (105, 4, True), (12345, 2, True), (1179648, 2, False),
            (65536, 4, False)]


@pytest.mark.parametrize("k", [1, 16])
@pytest.mark.parametrize("n_elems,elem_bytes,aligned", K6_PAGES)
def test_page_gather_quant_launch_plan_covers_every_page(n_elems, elem_bytes,
                                                         aligned, k):
    """K6's plan: the cluster's slices cover each page exactly once, every
    CTA gets a non-empty slice, what a CTA stages fits its shared memory,
    and at the serving shape a bf16 page is read from its pool once."""
    plan = K6.launch_info(n_elems, elem_bytes, k, aligned=aligned)
    c, per, unit = plan["cluster"], plan["units_per_cta"], plan["unit_elems"]
    assert plan["grid"] == [c, k] and 1 <= c <= K6.MAX_CLUSTER
    assert plan["vec"] == (aligned and n_elems % 16 == 0)
    assert unit == (16 if plan["vec"] else 1)
    units = n_elems // unit
    assert units * unit == n_elems               # units tile the page
    assert (c - 1) * per < units <= c * per      # each CTA has a slice
    assert 0 <= plan["held_units"] <= per
    assert plan["reread_units"] == per - plan["held_units"]
    assert plan["smem_bytes"] == plan["held_units"] * unit * elem_bytes
    assert plan["smem_bytes"] <= K6.SMEM_BYTES < 227 * 1024
    if not plan["vec"]:
        assert plan["held_units"] == 0
    elif per * unit * elem_bytes <= K6.SMEM_BYTES:
        assert plan["reread_units"] == 0          # the slice is held whole
    if (n_elems, elem_bytes, aligned) == (1179648, 2, True):
        assert (c, plan["smem_bytes"], plan["reread_units"]) \
            == (16, 147456, 0)


# =============================================================================
# the kernels on the card
# =============================================================================

@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_page_gather_quant_kernel_vs_plain_cuda(dtype):
    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(1)
    pool = (torch.randn((12, 2, 2, 16, 8, 128), generator=gen, device=dev)
            * 3).to(dtype)
    pool[5] = 0                                    # all-zero page: 1e-8 clamp
    idx = torch.tensor([5, 3, 11, 0, 3, 3, 7, 2], dtype=torch.int32,
                       device=dev)
    kernels.reset_launch_counts()
    q, s = K6.page_gather_quant(pool, idx)
    qp, sp = K6.page_gather_quant_plain(pool, idx)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["page_gather_quant"] == 1
    assert torch.equal(q, qp) and torch.equal(s, sp)
    ties = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 3.0]],
                        device=dev).to(dtype)
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    assert torch.equal(K6.page_gather_quant(ties, one)[0],
                       K6.page_gather_quant_plain(ties, one)[0])


def _quant_pool(shape, dtype, source, dev, seed):
    """A pool [slots, *shape] of seeded values on the card ("hbm"), in
    pinned host memory ("pinned"), or on the card at a base 2 or 4 bytes
    past 16-byte alignment ("unaligned"); slot 1 all zero."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = int(np.prod(shape))
    flat = (torch.randn(20 * n + 1, generator=gen, device=dev) * 3).to(dtype)
    pool = (flat[1:] if source == "unaligned" else flat[:-1]).view(20, *shape)
    pool[1] = 0
    if source == "pinned":
        pool = pool.cpu().pin_memory()
    return pool


@pytest.mark.requires_cuda
@pytest.mark.parametrize("source", ["hbm", "pinned", "unaligned"])
@pytest.mark.parametrize("shape", [(36, 2, 16, 8, 128), (3, 5, 7)])
@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_page_gather_quant_cluster_vs_plain_cuda(dtype, k, shape, source):
    """K6 vs plain, exact, over the serving page (bf16 held whole, float32
    held in part and the rest read again) and an odd page, from HBM,
    pinned host memory and an unaligned base; one launch a call; pages
    repeated as the pow2 padding repeats them."""
    dev = cuda_device()
    pool = _quant_pool(shape, dtype, source, dev, k)
    rng = np.random.RandomState(k)
    idx = torch.from_numpy(np.resize(rng.permutation(20)[:max(1, k - 2)],
                                     k).astype(np.int32)).to(dev)
    kernels.reset_launch_counts()
    q, s = K6.page_gather_quant(pool, idx)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["page_gather_quant"] == 1
    qp, sp = K6.page_gather_quant_plain(pool, idx)
    assert torch.equal(q, qp.to(dev)) and torch.equal(s, sp.to(dev))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("source", ["hbm", "pinned"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_page_gather_quant_graph_replay_cuda(dtype, source):
    """A CUDA graph of one K6 call, replayed on another index vector,
    equals the eager call (its attributes are raised by the first call
    only, and it makes no host sync, memset or allocation)."""
    dev = cuda_device()
    pool = _quant_pool((36, 2, 16, 8, 128), dtype, source, dev, 5)
    idx = torch.arange(16, dtype=torch.int32, device=dev)
    K6.page_gather_quant(pool, idx)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        q, s = K6.page_gather_quant(pool, idx)
    idx.copy_(torch.arange(19, 3, -1, dtype=torch.int32, device=dev))
    g.replay()
    torch.cuda.synchronize()
    qe, se = K6.page_gather_quant(pool, idx)
    torch.cuda.synchronize()
    assert torch.equal(q, qe) and torch.equal(s, se)
    qp, sp = K6.page_gather_quant_plain(pool, idx)
    assert torch.equal(q, qp.to(dev)) and torch.equal(s, sp.to(dev))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dequant_gather_kernel_vs_plain_cuda(pinned, dtype):
    dev = cuda_device()
    rng = np.random.RandomState(2)
    pq = torch.from_numpy(rng.randint(-127, 128, (9, 2, 2, 16, 8, 128))
                          .astype(np.int8))
    ps = torch.from_numpy((rng.rand(9) * 0.1 + 1e-3).astype(np.float32))
    if pinned:
        pq, ps = pq.pin_memory(), ps.pin_memory()
    else:
        pq, ps = pq.to(dev), ps.to(dev)
    idx = torch.tensor([8, 0, 4, 4], dtype=torch.int32, device=dev)
    got = K6.dequant_gather(pq, ps, idx, dtype)
    want = K6.dequant_gather_plain(pq, ps, idx, dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.requires_cuda
def test_page_checksum_1byte_kernel_vs_plain_cuda():
    """K5 over the pages of a pinned int8 tier, through the store."""
    dev = cuda_device()
    store = tiers.TierStore(tiers.StoreConfig(
        n_pages=8, page_shape=(2, 16, 8, 128), hierarchy=MemoryHierarchy
        .two_tier(4, 8, pinned_slow=True, quantize_slow=True)), device=dev)
    rng = np.random.RandomState(3)
    for p in range(8):
        assert store.allocate(p, 1)
        store.write_page(p, rng.standard_normal((2, 16, 8, 128))
                         .astype(np.float32))
    pool = store.pools[1].data
    assert pool.is_pinned() and pool.dtype == torch.int8
    idx = torch.tensor([7, 1, 3], dtype=torch.int32, device=dev)
    got = K5.page_checksum(pool, idx).view(torch.int32)
    want = K5.page_checksum_plain(pool, idx).view(torch.int32)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert_same(got.cpu().view(torch.uint32).numpy().astype(np.uint32),
                K5.checksum_np(store.pools[1].raw()[[7, 1, 3]]))
