"""The pinned-host NVM tier served in place, against the JAX package.

The JAX package's own pinned pool aborts on this CPU under jax 0.9.0
(ROADMAP C1), so no test here builds one.  The port is held against:

* the JAX numpy-host store for the store itself: the same writes and
  migrations leave the same page table, wear, remap and stored bits
  (the pinned pool keeps bf16 as bf16, the numpy pool as uint16 bits —
  the same 16-bit patterns);
* ``_decode_core_pinned`` and ``_fused_decode_pinned`` of a JAX engine
  built over the plain two-tier hierarchy, called with plain jnp pools;
* the JAX numpy-host engine end to end: the tier is lossless and
  decoding greedy, so the tokens must be identical.

Integer and host state match exactly.  KV pools: the entries a step
changed are the same entries in both packages (exact mask), every other
entry keeps its bits, and the values agree within atol 1e-5, rtol 1e-4
(XLA and torch project K/V in a different summation order).  Logits
within the same tolerance.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_close, assert_same, cap_threads
from repro.configs import registry as jregistry
from repro.configs import smoke as jsmoke
from repro.core import hierarchy as jhierarchy
from repro.core import migration as jmigration
from repro.core import sysmon as jsysmon
from repro.core import tiers as jtiers
from repro.models import transformer as JT
from repro.serving import PagedServingEngine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs.base import registry, smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import migration, tiers
from repro_torch.core.hierarchy import MemoryHierarchy
from repro_torch.serving.engine import PagedServingEngine, ServeConfig

cap_threads()

SEED = 0
SYSMON_FIELDS = ("reads", "writes", "access_count", "hist", "last_access",
                 "intv_cnt", "intv_sum", "intv_sqsum", "bank_freq",
                 "slab_freq", "page_bank", "page_slab", "sample_idx")


@pytest.fixture(scope="module")
def models():
    tcfg = smoke(registry()["qwen3_4b"])
    jcfg = jsmoke(jregistry()["qwen3_4b"])
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(SEED))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return tcfg, tparams, jcfg, jparams


def assert_pool_step(got, got_before, want, want_before):
    """One dispatch's effect on a pool, port against JAX: the same
    entries changed (exact mask), every other entry kept its bits, and
    the pools agree within the float tolerance."""
    got, want = np.asarray(got), np.asarray(want)
    moved = want != np.asarray(want_before)
    assert_same(got != np.asarray(got_before), moved)
    assert_same(got[~moved], np.asarray(got_before)[~moved])
    assert_close(got, want)


# =============================================================================
# the store
# =============================================================================

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pinned_store_matches_jax_host_store(dtype):
    """Writes, demotions, promotions and Start-Gap rotations through the
    port's pinned pool (page gather/scatter over the pool, host-side row
    swaps) against the JAX numpy-host store: same page table, traffic,
    wear, remap and stored bits."""
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    thier = MemoryHierarchy.two_tier(6, 16, pinned_slow=True,
                                     gap_write_interval=3)
    jhier = jhierarchy.MemoryHierarchy.two_tier(6, 16, gap_write_interval=3)
    ts = tiers.TierStore(tiers.StoreConfig(n_pages=16, page_shape=(3, 4),
                                           hierarchy=thier, dtype=tdt),
                         device="cpu")
    js = jtiers.TierStore(jtiers.StoreConfig(n_pages=16, page_shape=(3, 4),
                                             hierarchy=jhier, dtype=jdt))
    assert isinstance(ts.pools[1], tiers.PinnedHostPool)
    assert ts.is_pinned_tier(1) and ts.is_addressable_tier(1)
    assert ts.pools[1].data.dtype == tdt              # bf16 stays bf16
    rng = np.random.RandomState(1)
    for p in range(16):
        for s in (ts, js):
            assert s.allocate(p, 1)
        v = rng.standard_normal((3, 4)).astype(np.float32)
        ts.write_page(p, v)
        js.write_page(p, v)
    teng = migration.BatchedMigrationEngine(ts, chunk_pages=3)
    jeng = jmigration.BatchedMigrationEngine(js, chunk_pages=3)
    for pages, dst, locked in (([3, 1, 7, 9, 12], 0, True),
                               ([1, 7], 1, False),
                               ([0, 2, 4, 6, 8, 10], 0, True),
                               ([3, 12, 4, 8], 1, False)):
        a = (teng.migrate_locked if locked else teng.migrate_optimistic)(
            pages, dst)
        b = (jeng.migrate_locked if locked else jeng.migrate_optimistic)(
            pages, dst)
        assert a.to_dict() == b.to_dict()
    for p in (5, 11, 13):
        v = rng.standard_normal((3, 4)).astype(np.float32)
        ts.write_page(p, v)
        js.write_page(p, v)
    for f in ("tier", "slot", "version"):
        assert_same(getattr(ts, f), getattr(js, f))
    assert ts.traffic == js.traffic
    assert (ts.writes_to, ts.reads_from) == (js.writes_to, js.reads_from)
    tw, jw = ts.wear_by_tier[1], js.wear_by_tier[1]
    assert ts.leveler_by_tier[1].stats.advances > 0
    assert vars(ts.leveler_by_tier[1].stats) == \
        vars(js.leveler_by_tier[1].stats)
    assert_same(tw.wear_counts(), jw.wear_counts())
    assert_same(tw._remap, jw._remap)
    assert_same(ts.pools[1].raw(), js.pools[1].data)
    assert_same(ts.fast_pool.float(), np.asarray(js.fast_pool, np.float32))
    for p in range(16):
        np.testing.assert_array_equal(ts.read_page(p), js.read_page(p))


def test_pinned_pool_raw_view_is_zero_copy():
    """The host view the injector and the leveler use aliases the pool:
    a bit flipped through it is what the kernels read next."""
    store = tiers.TierStore(tiers.StoreConfig(
        n_pages=4, page_shape=(8,), dtype=torch.bfloat16,
        hierarchy=MemoryHierarchy.two_tier(2, 4, pinned_slow=True)),
        device="cpu")
    pool = store.pools[1]
    raw = pool.raw()
    assert raw.dtype == np.uint16
    raw[2, 3] ^= 0x8000
    assert pool.data[2, 3].view(torch.int16).item() == np.int16(-32768)
    pool.swap_rows(2, 0)
    assert pool.raw()[0, 3] == 0x8000 and pool.raw()[2, 3] == 0


# =============================================================================
# the dual-pool decode step and the fused dual-pool dispatch
# =============================================================================

N_FAST, N_PIN, PAGE = 6, 10, 4


def _engines(models, gap_write_interval=10_000, **kw):
    """A JAX engine over the plain two-tier hierarchy (its pinned dispatch
    functions are called with plain jnp pools) and the port's engine
    over the pinned one, at the same sizes."""
    tcfg, tparams, jcfg, jparams = models
    scfg = dict(page_size=PAGE, max_batch=3, fast_slots=N_FAST,
                slow_slots=N_PIN, max_pages_per_seq=4, **kw)
    jeng = JEngine(jcfg, jparams, JServeConfig(
        **scfg, hierarchy=jhierarchy.MemoryHierarchy.two_tier(
            N_FAST, N_PIN, gap_write_interval=gap_write_interval)))
    teng = PagedServingEngine(tcfg, tparams, ServeConfig(
        **scfg, hierarchy=MemoryHierarchy.two_tier(
            N_FAST, N_PIN, pinned_slow=True,
            gap_write_interval=gap_write_interval)), device="cpu")
    assert teng.pinned_tier == 1
    return jeng, teng


def _pools(teng, seed):
    """Random initial pools, installed in the port's store (in place)."""
    rng = np.random.RandomState(seed)
    fast = (rng.standard_normal(tuple(teng.kv.store.fast_pool.shape))
            * 0.5).astype(np.float32)
    pin = (rng.standard_normal(tuple(teng.kv.store.pools[1].data.shape))
           * 0.5).astype(np.float32)
    teng.kv.store.fast_pool.copy_(torch.from_numpy(fast))
    teng.kv.store.pools[1].data.copy_(torch.from_numpy(pin))
    return fast, pin


# block tables: row 0's tail lives in the pinned pool, row 1's in tier 0
# with the same numeric slot (2) as row 0's pinned tail, row 2 mixes
BT = np.array([[4, 0, 2, 0], [1, 5, 2, 0], [3, 7, 8, 0]], np.int32)
SEL = np.array([[0, 1, 1, 0], [1, 0, 0, 0], [0, 1, 1, 0]], np.int32)
POS = np.array([9, 8, 10], np.int32)          # tail column 2 in every row
REMAP = np.array([3, 0, 9, 1, 7, 2, 8, 4, 6, 5], np.int32)


def test_decode_core_pinned_matches_jax(models):
    """Teacher-forced dual-pool steps: pinned tail, fast tail and a
    numeric slot collision between the pools, with a non-identity remap.
    Both pools and the logits against JAX ``_decode_core_pinned``."""
    tcfg, tparams, jcfg, jparams = models
    jeng, teng = _engines(models)
    fast, pin = _pools(teng, SEED + 1)
    jfast, jpin = jnp.asarray(fast), jnp.asarray(pin)
    jstep = jax.jit(jeng._decode_core_pinned)
    rng = np.random.RandomState(SEED + 2)
    pos = POS.copy()
    tfast = teng.kv.store.fast_pool
    tpin = teng.kv.store.pools[1].data
    for _ in range(2):
        tok = rng.randint(0, tcfg.vocab, size=3).astype(np.int32)
        f0, p0 = np.asarray(jfast), np.asarray(jpin)
        tf0, tp0 = tfast.numpy().copy(), tpin.numpy().copy()
        jlogits, _, jfast, jpin = jstep(
            jparams, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(BT),
            jnp.asarray(SEL), jnp.asarray(pos + 1), jfast, jpin,
            jnp.asarray(REMAP))
        tlogits, _ = teng._decode_core_pinned(
            torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(BT), torch.from_numpy(SEL),
            torch.from_numpy(pos + 1), torch.from_numpy(REMAP))
        assert_pool_step(tfast, tf0, jfast, f0)
        assert_pool_step(tpin, tp0, jpin, p0)
        assert (np.asarray(jpin) != p0).any() \
            and (np.asarray(jfast) != f0).any()    # both pools appended
        assert_close(tlogits, np.asarray(jlogits))
        assert_same(tlogits.argmax(-1), np.asarray(jlogits).argmax(-1))
        pos = pos + 1


@pytest.mark.parametrize("k,gap_interval", [(1, 2), (4, 3)])
def test_fused_decode_pinned_matches_jax(models, k, gap_interval):
    """The fused K-step dual-pool dispatch with in-dispatch Start-Gap
    against JAX ``_fused_decode_pinned``: tokens, page writes, SysMon,
    wear, remap, gap, pending and advances exactly; pools as above."""
    tcfg, tparams, jcfg, jparams = models
    jeng, teng = _engines(models)
    fast, pin = _pools(teng, SEED + 3)
    rng = np.random.RandomState(SEED + 4)
    B, P = BT.shape
    prompt_len = np.array([4, 11, 2], np.int32)       # row 1 still replays
    prompt_buf = rng.randint(0, tcfg.vocab, (B, P * PAGE)).astype(np.int32)
    tokens = prompt_buf[np.arange(B), POS]
    page_tables = np.array([[0, 1, 2, 0], [3, 4, 5, 0], [6, 7, 8, 0]],
                           np.int32)
    wear0 = rng.randint(0, 5, N_PIN).astype(np.int32)
    gap0, pending0 = 4, gap_interval - 1
    sm = jsysmon.init(jeng.kv.n_pages, n_banks=jeng.kv.store.cfg.n_banks,
                      n_slabs=jeng.kv.store.cfg.n_slabs)
    fn = jax.jit(partial(jeng._fused_decode_pinned, k_steps=k,
                         gap_interval=gap_interval))
    (jsampled, jlogits, jsm, jfast, jpin, jwear, jremap, jgap, jpending,
     jn_adv, jpw, _) = fn(
        jparams, *(jnp.asarray(a) for a in (
            tokens, POS, prompt_buf, prompt_len, page_tables, BT, SEL)),
        sm, jnp.asarray(fast), jnp.asarray(pin), jnp.asarray(wear0),
        jnp.asarray(REMAP), jnp.int32(gap0), jnp.int32(pending0))
    args = [torch.from_numpy(a) for a in (
        tokens, POS, prompt_buf, prompt_len, page_tables, BT, SEL)]
    wear = torch.from_numpy(wear0.copy())
    (sampled, page_writes, logits, twear, tremap, gap, pending,
     n_adv) = teng._fused_decode_pinned(
        *args, wear, torch.from_numpy(REMAP), gap0, pending0, k_steps=k,
        gap_interval=gap_interval)
    assert int(jn_adv) == n_adv > 0
    assert (int(jgap), int(jpending)) == (gap, pending)
    assert_same(twear, jwear)
    assert twear is wear                               # updated in place
    assert_same(tremap, jremap)
    assert_same(sampled, jsampled)
    assert_same(page_writes, jpw)
    for f in SYSMON_FIELDS:
        assert_same(getattr(teng.sysmon, f), getattr(jsm, f))
    assert_pool_step(teng.kv.store.fast_pool, fast, jfast, fast)
    assert_pool_step(teng.kv.store.pools[1].data, pin, jpin, pin)
    assert_close(logits, np.asarray(jlogits))


# =============================================================================
# the engine end to end
# =============================================================================

def _prompts(vocab):
    rng = np.random.RandomState(SEED)
    return [rng.randint(0, vocab, size=n).tolist() for n in (5, 3, 9, 6)]


def _run_port(models, prompts, max_new=16, **kw):
    tcfg, tparams, _, _ = models
    eng = PagedServingEngine(tcfg, tparams, ServeConfig(**kw), device="cpu")
    reqs = [eng.submit(p, max_new) for p in prompts]
    eng.run(max_steps=600)
    assert eng.batcher.all_done()
    return eng, reqs


SCFG = dict(page_size=8, max_batch=3, fast_slots=4, slow_slots=64,
            memos_interval=8, decode_block=8)


def test_pinned_engine_tokens_match_jax_host_engine(models):
    """The port serving out of the pinned pool in place against the JAX
    engine promoting out of its numpy host tier: identical tokens."""
    tcfg, tparams, jcfg, jparams = models
    prompts = _prompts(tcfg.vocab)
    jeng = JEngine(jcfg, jparams, JServeConfig(**SCFG))
    jreqs = [jeng.submit(p, 16) for p in prompts]
    jeng.run(max_steps=600)
    teng, treqs = _run_port(models, prompts, **SCFG,
                            hierarchy=MemoryHierarchy.two_tier(
                                4, 64, pinned_slow=True))
    for j, t in zip(jreqs, treqs):
        assert t.generated == j.generated
        assert t.error is None and j.error is None
    store = teng.kv.store
    assert store.wear_by_tier[1].writes_total > 0, \
        "no KV append ever landed in the pinned tier"
    assert store.traffic[(0, 1)] > 0
    assert store.reads_from[1] > 0


@pytest.mark.parametrize("k", [1, 4, 8])
def test_pinned_fused_matches_reference_in_port(models, k):
    """The port's fused dual-pool dispatch against its K=1 reference
    path, memos off and Start-Gap out of the window: tokens, every
    SysMon counter, version/read/write accounting, both pools and the
    pinned tier's wear counters are identical."""
    tcfg = models[0]
    prompts = _prompts(tcfg.vocab)[:3]
    kw = dict(page_size=8, max_batch=3, fast_slots=2, slow_slots=128,
              memos_enabled=False)
    runs = [_run_port(models, prompts, reference=ref, decode_block=k,
                      hierarchy=MemoryHierarchy.two_tier(
                          2, 128, pinned_slow=True,
                          gap_write_interval=10_000), **kw)
            for ref in (True, False)]
    (r, rreqs), (f, freqs) = runs
    sr, sf = r.kv.store, f.kv.store
    assert sr.wear_by_tier[1].writes_total > 0
    assert [q.generated for q in rreqs] == [q.generated for q in freqs]
    for name in SYSMON_FIELDS:
        assert_same(getattr(r.sysmon, name), getattr(f.sysmon, name))
    assert_same(sr.version, sf.version)
    assert (sr.writes_to, sr.reads_from) == (sf.writes_to, sf.reads_from)
    assert_same(sr.fast_pool, sf.fast_pool)
    assert_same(sr.pools[1].data, sf.pools[1].data)
    assert_same(sr.wear_by_tier[1].wear_counts(),
                sf.wear_by_tier[1].wear_counts())
    assert sr.wear_by_tier[1].writes_total == sf.wear_by_tier[1].writes_total


@pytest.mark.parametrize("k", [1, 4, 8])
def test_pinned_fused_leveling_matches_reference_in_port(models, k):
    """In-dispatch Start-Gap against the reference path's host leveler:
    advances, gap, rotations, pending, leveling writes, remap and pool
    bytes identical; the per-row wear attribution is exact at K=1 and
    conserved in total for K>1 (the JAX package's own pin)."""
    tcfg = models[0]
    prompts = _prompts(tcfg.vocab)[:3]
    kw = dict(page_size=8, max_batch=3, fast_slots=2, slow_slots=16,
              memos_enabled=False)
    runs = [_run_port(models, prompts, reference=ref, decode_block=k,
                      hierarchy=MemoryHierarchy.two_tier(
                          2, 16, pinned_slow=True, gap_write_interval=4),
                      **kw)
            for ref in (True, False)]
    (r, rreqs), (f, freqs) = runs
    assert f._gap_interval == 4
    wr, wf = r.kv.store.wear_by_tier[1], f.kv.store.wear_by_tier[1]
    lr, lf = r.kv.store.leveler_by_tier[1], f.kv.store.leveler_by_tier[1]
    assert lf.stats.advances > 0
    assert lf.stats == lr.stats
    assert lf._pending == lr._pending
    assert wf.leveling_writes == wr.leveling_writes > 0
    assert wf.writes_total == wr.writes_total
    assert_same(wf._remap, wr._remap)
    if k == 1:
        assert_same(wf.wear_counts(), wr.wear_counts())
    else:
        assert wf.wear_counts().sum() == wr.wear_counts().sum()
    wr.check()
    wf.check()
    assert [q.generated for q in rreqs] == [q.generated for q in freqs]
    assert_same(r.kv.store.pools[1].data, f.kv.store.pools[1].data)
