"""MoE serving in the port's ``PagedServingEngine`` against the JAX
engine, at smoke width of olmoe_1b_7b (8 experts, top 2, softmax first)
and mixtral_8x7b (top 2 of the logits, then a softmax) in float32, with
carried weights (``params_from_jax``) and the same prompts.

Paths: the K=1 reference path and the fused K-step dispatch over the
tier-0 pool (a small HBM pool, so pages migrate and sequences are
preempted); the fused dispatch over two pools (a pinned-host NVM tier
served in place, against the JAX engine over its numpy host tier, and
the dual-pool dispatch against JAX ``_fused_decode_pinned`` called with
plain jnp pools); the bucketed packed prefill, whose padding rows must
not count; and 2 active rows under ``max_batch`` 4, where the port pads
the decode to 4 rows and must not count the padding.  Generated tokens
and ``expert_counts`` must be exact.
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
from repro.core import sysmon as jsysmon
from repro.models import transformer as JT
from repro.serving import PagedServingEngine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs.base import registry, smoke
from repro_torch.convert import params_from_jax
from repro_torch.core.hierarchy import MemoryHierarchy
from repro_torch.serving.engine import PagedServingEngine, ServeConfig

cap_threads()

SEED = 0
ARCHS = ("olmoe_1b_7b", "mixtral_8x7b")


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    tcfg = smoke(registry()[request.param])
    jcfg = jsmoke(jregistry()[request.param])
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(SEED))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return tcfg, tparams, jcfg, jparams


def _prompts(vocab, sizes=(5, 3, 9, 6)):
    rng = np.random.RandomState(SEED)
    return [rng.randint(0, vocab, size=n).tolist() for n in sizes]


SCFG = dict(page_size=8, max_batch=3, fast_slots=8, slow_slots=128,
            memos_interval=8, decode_block=8)


def _serve(eng, prompts, max_new):
    reqs = [eng.submit(p, max_new) for p in prompts]
    eng.run(max_steps=600)
    assert eng.batcher.all_done()
    return reqs


def _run_both(models, prompts, max_new=16, jhier=None, thier=None, **kw):
    tcfg, tparams, jcfg, jparams = models
    scfg = {**SCFG, **kw}
    jeng = JEngine(jcfg, jparams, JServeConfig(**scfg, hierarchy=jhier))
    teng = PagedServingEngine(tcfg, tparams, ServeConfig(
        **scfg, hierarchy=thier), device="cpu")
    jreqs = _serve(jeng, prompts, max_new)
    treqs = _serve(teng, prompts, max_new)
    for j, t in zip(jreqs, treqs):
        assert t.generated == j.generated
        assert t.error is None and j.error is None
    assert teng.expert_counts.dtype == np.int64
    assert_same(teng.expert_counts, jeng.expert_counts)
    return jeng, teng, treqs


def _identity(cfg, prompts, max_new):
    """Σ(prompt + max_new - 1) x top_k x n_layers: every processed token
    routed once per layer."""
    return sum(len(p) + max_new - 1 for p in prompts) * cfg.top_k \
        * cfg.n_layers


@pytest.mark.parametrize("reference", [True, False])
def test_moe_engine_matches_jax(models, reference):
    """Tokens, expert counts, SysMon and the page table against the JAX
    engine on the reference path and the fused dispatch, with HBM
    pressure: a preempted sequence keeps its pages and resumes where it
    stopped, so every processed token is still routed once per layer."""
    cfg = models[0]
    prompts = _prompts(cfg.vocab)
    jeng, teng, _ = _run_both(models, prompts, reference=reference)
    assert teng.batcher.n_preempted == jeng.batcher.n_preempted > 0
    assert teng.expert_counts.sum() == _identity(cfg, prompts, 16)
    for f in ("reads", "writes", "access_count"):
        assert_same(getattr(teng.sysmon, f), getattr(jeng.sysmon, f))
    for f in ("tier", "slot", "version"):
        assert_same(getattr(teng.kv.store, f), getattr(jeng.kv.store, f))
    assert_close(teng.last_logits, np.asarray(jeng.last_logits))


def test_two_active_rows_under_max_batch_4(models):
    """The port pads each decode step to ``max_batch`` rows and routes
    the padding; only the 2 real rows count, as in the JAX engine, which
    decodes 2 rows.  No preemption: the counts meet the identity."""
    cfg = models[0]
    prompts = _prompts(cfg.vocab, (7, 4))
    for reference in (True, False):
        jeng, teng, _ = _run_both(models, prompts, max_new=10,
                                  reference=reference, max_batch=4,
                                  fast_slots=32)
        assert teng.batcher.n_preempted == 0
        assert teng.expert_counts.sum() == _identity(cfg, prompts, 10)


def test_moe_prefill_expert_counts_exclude_padding(models):
    """Bucketed packed prefill: the bucket's padding rows are routed but
    not counted, so the counts equal the replaying reference's and the
    JAX prefill engine's exactly."""
    cfg = models[0]
    prompts = [[5, 7, 9, 11, 13], [21, 22, 23, 24, 25, 26], [1, 2, 3, 4]]
    kw = dict(fast_slots=32, max_new=3, decode_block=4)
    _, ref, rr = _run_both(models, prompts, reference=True, **kw)
    _, pre, rp = _run_both(models, prompts, prefill=True, **kw)
    for a, b in zip(rr, rp):
        assert a.generated == b.generated
    assert_same(pre.expert_counts, ref.expert_counts)
    assert pre.expert_counts.sum() == _identity(cfg, prompts, 3)


def test_pinned_moe_engine_matches_jax_host_engine(models):
    """The fused dispatch over two pools (pages served in place from a
    pinned-host tier, with and without prefill) against the JAX engine
    over its numpy host tier: identical tokens and expert counts."""
    cfg = models[0]
    prompts = _prompts(cfg.vocab)
    for prefill in (False, True):
        _, teng, _ = _run_both(
            models, prompts, prefill=prefill, fast_slots=4,
            slow_slots=64,
            thier=MemoryHierarchy.two_tier(4, 64, pinned_slow=True))
        assert teng.kv.store.wear_by_tier[1].writes_total > 0


N_FAST, N_PIN, PAGE = 6, 10, 4
BT = np.array([[4, 0, 2, 0], [1, 5, 2, 0], [3, 7, 8, 0]], np.int32)
SEL = np.array([[0, 1, 1, 0], [1, 0, 0, 0], [0, 1, 1, 0]], np.int32)
POS = np.array([9, 8, 10], np.int32)
REMAP = np.array([3, 0, 9, 1, 7, 2, 8, 4, 6, 5], np.int32)


def test_fused_decode_pinned_counts_match_jax(models):
    """The dual-pool K-step dispatch against JAX ``_fused_decode_pinned``
    (plain jnp pools): tokens, page writes and the dispatch's expert
    counts, which the port adds to ``expert_counts`` from its one host
    read of the counters."""
    tcfg, tparams, jcfg, jparams = models
    k, gap_interval = 4, 3
    scfg = dict(page_size=PAGE, max_batch=3, fast_slots=N_FAST,
                slow_slots=N_PIN, max_pages_per_seq=4)
    jeng = JEngine(jcfg, jparams, JServeConfig(
        **scfg, hierarchy=jhierarchy.MemoryHierarchy.two_tier(N_FAST,
                                                              N_PIN)))
    teng = PagedServingEngine(tcfg, tparams, ServeConfig(
        **scfg, hierarchy=MemoryHierarchy.two_tier(N_FAST, N_PIN,
                                                   pinned_slow=True)),
        device="cpu")
    rng = np.random.RandomState(SEED + 3)
    fast = (rng.standard_normal(tuple(teng.kv.store.fast_pool.shape))
            * 0.5).astype(np.float32)
    pin = (rng.standard_normal(tuple(teng.kv.store.pools[1].data.shape))
           * 0.5).astype(np.float32)
    teng.kv.store.fast_pool.copy_(torch.from_numpy(fast))
    teng.kv.store.pools[1].data.copy_(torch.from_numpy(pin))
    B, P = BT.shape
    prompt_len = np.array([4, 11, 2], np.int32)
    prompt_buf = rng.randint(0, tcfg.vocab, (B, P * PAGE)).astype(np.int32)
    tokens = prompt_buf[np.arange(B), POS]
    page_tables = np.array([[0, 1, 2, 0], [3, 4, 5, 0], [6, 7, 8, 0]],
                           np.int32)
    wear0 = rng.randint(0, 5, N_PIN).astype(np.int32)
    sm = jsysmon.init(jeng.kv.n_pages, n_banks=jeng.kv.store.cfg.n_banks,
                      n_slabs=jeng.kv.store.cfg.n_slabs)
    fn = jax.jit(partial(jeng._fused_decode_pinned, k_steps=k,
                         gap_interval=gap_interval))
    out = fn(jparams, *(jnp.asarray(a) for a in (
        tokens, POS, prompt_buf, prompt_len, page_tables, BT, SEL)),
        sm, jnp.asarray(fast), jnp.asarray(pin), jnp.asarray(wear0),
        jnp.asarray(REMAP), jnp.int32(4), jnp.int32(gap_interval - 1))
    jsampled, jpw, jcounts = out[0], out[10], out[11]
    args = [torch.from_numpy(a) for a in (
        tokens, POS, prompt_buf, prompt_len, page_tables, BT, SEL)]
    before = teng.expert_counts.copy()
    sampled, page_writes, *_ = teng._fused_decode_pinned(
        *args, torch.from_numpy(wear0.copy()), torch.from_numpy(REMAP), 4,
        gap_interval - 1, k_steps=k, gap_interval=gap_interval)
    assert_same(sampled, jsampled)
    assert_same(page_writes, jpw)
    assert_same(teng.expert_counts - before, np.asarray(jcounts))
    assert int(np.asarray(jcounts).sum()) == \
        k * B * tcfg.top_k * tcfg.n_layers
