"""The dense archs the paged engine serves besides qwen3_4b, against the
JAX engine at smoke width in float32 with carried weights
(``params_from_jax``) and the same prompts: phi3_mini_3_8b (as many KV
heads as query heads, G = 1), qwen2_5_14b (QKV bias) and gemma3_4b
(gemma norms, scaled and tied embeddings; at smoke width D = 32, where
the published D = 256).

A small HBM pool makes every run preempt, demote and promote.  Tokens,
every SysMon counter, the page table (tier, slot, version) and the
allocator's slots must match exactly; the last logits and the tier-0
pool within ``atol=1e-5, rtol=1e-4``.
"""
import jax
import numpy as np
import pytest

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
SCFG = dict(page_size=8, max_batch=3, fast_slots=8, slow_slots=128,
            memos_interval=8, decode_block=8)


@pytest.fixture(scope="module",
                params=["phi3_mini_3_8b", "qwen2_5_14b", "gemma3_4b"])
def models(request):
    tcfg = smoke(registry()[request.param])
    jcfg = jsmoke(jregistry()[request.param])
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(SEED))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return tcfg, tparams, jcfg, jparams


@pytest.mark.parametrize("reference", [True, False])
def test_dense_arch_engine_matches_jax(models, reference):
    tcfg, tparams, jcfg, jparams = models
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, tcfg.vocab, size=n).tolist()
               for n in (5, 3, 9, 6)]
    scfg = dict(SCFG, reference=reference)
    jeng = JEngine(jcfg, jparams, JServeConfig(**scfg))
    teng = PagedServingEngine(tcfg, tparams, ServeConfig(**scfg),
                              device="cpu")
    jreqs = [jeng.submit(p, 16) for p in prompts]
    treqs = [teng.submit(p, 16) for p in prompts]
    jeng.run(max_steps=600)
    teng.run(max_steps=600)
    assert jeng.batcher.all_done() and teng.batcher.all_done()
    for j, t in zip(jreqs, treqs):
        assert t.generated == j.generated
        assert (t.first_token_step, t.finish_step, t.error) == \
            (j.first_token_step, j.finish_step, j.error)
    assert teng.expert_counts is None
    assert teng.batcher.n_preempted == jeng.batcher.n_preempted > 0
    for f in SYSMON_FIELDS:
        assert_same(getattr(teng.sysmon, f), getattr(jeng.sysmon, f))
    ts, js = teng.kv.store, jeng.kv.store
    for f in ("tier", "slot", "version"):
        assert_same(getattr(ts, f), getattr(js, f))
    for ta, ja in zip(ts.alloc, js.alloc):
        assert (ta._allocated, ta._free_blocks, ta.n_free) == \
            (ja._allocated, ja._free_blocks, ja.n_free)
    assert ts.traffic == js.traffic
    assert_close(ts.fast_pool, np.asarray(js.fast_pool))
    assert_close(teng.last_logits, np.asarray(jeng.last_logits))
