"""The slice as a whole: the port's ``PagedServingEngine`` against the JAX
engine, at smoke width of qwen3_4b in float32, with carried weights
(``params_from_jax``) and the same prompts.

A small HBM pool and a short memos interval make every run preempt,
demote and promote KV pages, so the whole loop runs — SysMon records,
pass classification, placement, batched migration, Start-Gap wear.
Integer and host state must match exactly: generated tokens, every
SysMon counter, the page table, versions, traffic bytes and each memos
report's migration and NVM fields.  Floats (the KV pool, the last
logits) match within ``atol=1e-5, rtol=1e-4``.  The seed is chosen so
the top-1/top-2 logit margin of every teacher-forced step stays far
above that tolerance, so a token that flips means a real fault.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_close, assert_same, cap_threads
from repro.configs import registry as jregistry
from repro.configs import smoke as jsmoke
from repro.models import transformer as JT
from repro.serving import PagedServingEngine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs.base import registry, smoke
from repro_torch.convert import params_from_jax
from repro_torch.serving.engine import PagedServingEngine, ServeConfig

cap_threads()

SEED = 0
SYSMON_FIELDS = ("reads", "writes", "access_count", "hist", "last_access",
                 "intv_cnt", "intv_sum", "intv_sqsum", "bank_freq",
                 "slab_freq", "page_bank", "page_slab", "sample_idx")
NVM_EXACT = ("passes", "slow_reads", "slow_writes", "leveling_writes",
             "wear_max")
NVM_FLOAT = ("read_energy_mj", "write_energy_mj", "dynamic_power_mw",
             "wear_mean", "lifetime_years_actual")


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


# 8 HBM slots of 8-token pages for three concurrent sequences of up to
# 25 tokens: the pool overflows, so preemption, demotion and promotion
# all happen; the memos interval divides the fused block
SCFG = dict(page_size=8, max_batch=3, fast_slots=8, slow_slots=128,
            memos_interval=8, decode_block=8)


def _run_both(models, **kw):
    tcfg, tparams, jcfg, jparams = models
    prompts = _prompts(tcfg.vocab)
    scfg = {**SCFG, **kw}
    jeng = JEngine(jcfg, jparams, JServeConfig(**scfg))
    teng = PagedServingEngine(tcfg, tparams, ServeConfig(**scfg),
                              device="cpu")
    jreqs = [jeng.submit(p, 16) for p in prompts]
    treqs = [teng.submit(p, 16) for p in prompts]
    jhist = jeng.run(max_steps=600)
    thist = teng.run(max_steps=600)
    assert jeng.batcher.all_done() and teng.batcher.all_done()
    return jeng, jreqs, jhist, teng, treqs, thist


@pytest.mark.parametrize("reference", [True, False])
def test_engine_matches_jax(models, reference):
    jeng, jreqs, jhist, teng, treqs, thist = _run_both(models,
                                                       reference=reference)
    for j, t in zip(jreqs, treqs):
        assert t.generated == j.generated
        assert t.tokens == j.tokens
        assert (t.first_token_step, t.finish_step, t.error) == \
            (j.first_token_step, j.finish_step, j.error)
    assert [h.get("decode_block") for h in thist] == \
        [h.get("decode_block") for h in jhist]
    assert teng.tokens_out == jeng.tokens_out
    assert teng.batcher.n_preempted == jeng.batcher.n_preempted > 0
    for f in SYSMON_FIELDS:
        assert_same(getattr(teng.sysmon, f), getattr(jeng.sysmon, f))
    ts, js = teng.kv.store, jeng.kv.store
    for f in ("tier", "slot", "version"):
        assert_same(getattr(ts, f), getattr(js, f))
    assert ts.traffic == js.traffic
    assert ts.traffic[(0, 1)] > 0 and ts.traffic[(1, 0)] > 0
    assert (ts.writes_to, ts.reads_from) == (js.writes_to, js.reads_from)
    assert teng.memos.engine.stats.to_dict() == \
        jeng.memos.engine.stats.to_dict()
    assert len(teng.memos.reports) == len(jeng.memos.reports) > 0
    for t, j in zip(teng.memos.reports, jeng.memos.reports):
        assert t.step == j.step
        for f in ("migrated", "to_fast", "to_slow", "bytes_moved",
                  "dirty_discards"):
            assert getattr(t.migrations, f) == getattr(j.migrations, f), f
        assert (t.n_marked, t.tier_pages, t.wear_pressure) == \
            (j.n_marked, j.tier_pages, j.wear_pressure)
        tn, jn = t.nvm.to_dict(), j.nvm.to_dict()
        assert {f: tn[f] for f in NVM_EXACT} == {f: jn[f] for f in NVM_EXACT}
        np.testing.assert_allclose([tn[f] for f in NVM_FLOAT],
                                   [jn[f] for f in NVM_FLOAT], rtol=1e-12)
    assert_same(ts.wear.wear_counts(), js.wear.wear_counts())
    assert ts.wear.writes_total == js.wear.writes_total > 0
    assert_same(ts.wear._remap, js.wear._remap)
    assert_close(ts.fast_pool, np.asarray(js.fast_pool))
    assert_close(teng.last_logits, np.asarray(jeng.last_logits))


@pytest.mark.parametrize("memos", [False, True])
def test_fused_matches_reference_in_port(models, memos):
    """The port's own fused dispatch against its K=1 reference, as the
    JAX package pins its own: without memos every SysMon counter and the
    fast-tier accounting are identical; with memos migrating between
    dispatches the pass boundaries align, so the tokens and the WD
    history match."""
    tcfg, tparams, _, _ = models
    runs = []
    for reference in (True, False):
        eng = PagedServingEngine(
            tcfg, tparams, ServeConfig(**SCFG, reference=reference,
                                       memos_enabled=memos), device="cpu")
        reqs = [eng.submit(p, 16) for p in _prompts(tcfg.vocab)]
        eng.run(max_steps=600)
        runs.append((eng, reqs))
    (r, rreqs), (f, freqs) = runs
    assert [q.generated for q in rreqs] == [q.generated for q in freqs]
    assert_same(r.sysmon.hist, f.sysmon.hist)
    assert len(r.memos.reports) == len(f.memos.reports)
    if not memos:
        for name in SYSMON_FIELDS:
            assert_same(getattr(r.sysmon, name), getattr(f.sysmon, name))
        assert_same(r.kv.store.version, f.kv.store.version)
        assert r.kv.store.writes_to == f.kv.store.writes_to
        assert r.kv.store.reads_from == f.kv.store.reads_from


def test_decode_core_teacher_forced(models):
    """Four teacher-forced decode steps on one shared pool and block
    table: logits and the pool (written in place, before attention)
    agree with the JAX ``_decode_core`` at every step, and the port never
    replaces its pool tensor."""
    tcfg, tparams, jcfg, jparams = models
    scfg = dict(page_size=4, max_batch=3, fast_slots=12, slow_slots=16)
    jeng = JEngine(jcfg, jparams, JServeConfig(**scfg))
    teng = PagedServingEngine(tcfg, tparams, ServeConfig(**scfg),
                              device="cpu")
    rng = np.random.RandomState(SEED + 1)
    shape = tuple(teng.kv.store.fast_pool.shape)
    pool0 = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    tpool = teng.kv.store.fast_pool
    tpool.copy_(torch.from_numpy(pool0))
    jpool = jnp.asarray(pool0)
    jdecode = jax.jit(jeng._decode_core)
    B, P = 3, 3
    bt = np.stack([rng.permutation(12)[:P] for _ in range(B)]
                  ).astype(np.int32)
    pos = np.array([2, 5, 8], np.int32)                  # ragged
    for _ in range(4):
        tok = rng.randint(0, tcfg.vocab, size=B).astype(np.int32)
        jlogits, _, jpool = jdecode(
            jparams, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(bt),
            jnp.asarray(pos + 1), jpool)
        tlogits = teng._decode_core(torch.from_numpy(tok),
                                    torch.from_numpy(pos),
                                    torch.from_numpy(bt),
                                    torch.from_numpy(pos + 1))
        assert teng.kv.store.fast_pool is tpool
        assert_close(tpool, np.asarray(jpool))
        assert_close(tlogits, np.asarray(jlogits))
        top2 = np.sort(np.asarray(jlogits)[:, :tcfg.vocab], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 100 * 1e-5
        assert_same(tlogits.argmax(-1), np.asarray(jlogits).argmax(-1))
        pos = pos + 1
