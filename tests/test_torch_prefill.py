"""Bucketed packed prefill of the port against the JAX package and
against the port's own prompt-replay path (twins of
``tests/test_prefill.py``).

* Buckets, packing and the replay page counts: exact against the JAX
  functions.
* Within the port, prefill-then-decode against the K=1 prompt-replay
  reference: identical tokens, SysMon raw counters and store accounting;
  pools within the fp32 tolerance (the prefill's dense math runs on the
  bucket's rows, the replay's on one row at a time).  Packed against
  unpacked prefill: the same.
* The port's prefill engine against the JAX prefill engine (memos off
  and on): identical tokens, every SysMon counter (the streaming
  sampling's cadence included), page table, accounting and wear; pools
  and logits within atol 1e-5, rtol 1e-4.
* The dual-pool prefill: the port's ``_core_pinned`` against the JAX
  ``PrefillRunner._core_pinned`` called with plain jnp pools (the JAX
  pinned pool aborts on this CPU, ROADMAP C1), and the port's pinned
  prefill engine against its pinned replay reference, wear included,
  and against the JAX numpy-host prefill engine's tokens.
* ``max_new=1``, ``submit`` rejection and TTFT stamping.

The JAX tests of AOT warmup (``n_compiles``) and of MoE prefill have no
twin: the port runs eagerly and serves dense models only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_close, assert_same, cap_threads
from repro.configs import registry as jregistry
from repro.configs import smoke as jsmoke
from repro.core import hierarchy as jhierarchy
from repro.faults.errors import CapacityError as JCapacityError
from repro.models import transformer as JT
from repro.serving import PagedServingEngine as JEngine
from repro.serving import ServeConfig as JServeConfig
from repro.serving import prefill as jprefill
from repro_torch import obs
from repro_torch.configs.base import registry, smoke
from repro_torch.convert import params_from_jax
from repro_torch.core.hierarchy import MemoryHierarchy
from repro_torch.faults.errors import CapacityError
from repro_torch.serving import prefill
from repro_torch.serving.engine import PagedServingEngine, ServeConfig

cap_threads()

SEED = 0
SYSMON_FIELDS = ("reads", "writes", "access_count", "hist", "last_access",
                 "intv_cnt", "intv_sum", "intv_sqsum", "bank_freq",
                 "slab_freq", "page_bank", "page_slab", "sample_idx")
# prefill collapses the sampling cadence on purpose: against replay only
# the event totals must match
SYSMON_RAW = ("reads", "writes", "bank_freq", "slab_freq")


@pytest.fixture(scope="module")
def models():
    tcfg = smoke(registry()["qwen3_4b"])
    jcfg = jsmoke(jregistry()["qwen3_4b"])
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(SEED))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return tcfg, tparams, jcfg, jparams


BASE = dict(page_size=8, max_batch=3, fast_slots=32, slow_slots=128,
            memos_enabled=False)
PROMPTS = [list(range(5, 17)), list(range(30, 42)), list(range(50, 62))]
SHORT = [[5, 7, 9, 11, 13], [21, 22, 23, 24, 25, 26], [1, 2, 3, 4]]


def _port(models, prompts, max_new=6, **kw):
    tcfg, tparams, _, _ = models
    eng = PagedServingEngine(tcfg, tparams, ServeConfig(**{**BASE, **kw}),
                             device="cpu")
    reqs = [eng.submit(p, max_new) for p in prompts]
    eng.run(max_steps=600)
    assert eng.batcher.all_done()
    return eng, reqs


def _jax(models, prompts, max_new=6, **kw):
    _, _, jcfg, jparams = models
    eng = JEngine(jcfg, jparams, JServeConfig(**{**BASE, **kw}))
    reqs = [eng.submit(p, max_new) for p in prompts]
    eng.run(max_steps=600)
    assert eng.batcher.all_done()
    return eng, reqs


def _assert_replay_parity(ref, pre, rref, rpre):
    for a, b in zip(rref, rpre):
        assert a.generated == b.generated
        assert a.tokens == b.tokens
    for f in SYSMON_RAW:
        assert_same(getattr(pre.sysmon, f), getattr(ref.sysmon, f))
    sr, sp = ref.kv.store, pre.kv.store
    assert_same(sp.version, sr.version)
    assert (sp.writes_to, sp.reads_from) == (sr.writes_to, sr.reads_from)
    for pa, pb in zip(sr.pools, sp.pools):
        assert_close(pb.data, pa.data)


# =============================================================================
# buckets and packing
# =============================================================================

def test_buckets_match_jax():
    for n in range(1, 300):
        b = prefill.bucket_for(n, min_bucket=16, max_bucket=512)
        assert b == jprefill.bucket_for(n, min_bucket=16, max_bucket=512)
        assert b >= max(n, 16) and b & (b - 1) == 0
        assert b == 16 or b // 2 < max(n, 16)
    for fn in (prefill.bucket_for, jprefill.bucket_for):
        with pytest.raises(ValueError):
            fn(513, min_bucket=16, max_bucket=512)
    assert prefill.bucket_list(16, 128) == jprefill.bucket_list(16, 128) \
        == [16, 32, 64, 128]
    assert [prefill.next_pow2(n) for n in range(1, 70)] == \
        [jprefill.next_pow2(n) for n in range(1, 70)]


class _FakeReq:
    def __init__(self, n):
        self.prompt = list(range(n))


@pytest.mark.parametrize("pack", [True, False])
def test_packing_matches_jax(pack):
    lens = [3, 5, 2, 9, 1, 1, 1, 1, 1, 30, 4]
    reqs = [_FakeReq(n) for n in lens]
    kw = dict(min_bucket=8, max_bucket=64, pack=pack, max_segments=4)
    groups = prefill.pack_prompts(reqs, **kw)
    jgroups = jprefill.pack_prompts(reqs, **kw)
    assert [(g.bucket, g.requests) for g in groups] == \
        [(g.bucket, g.requests) for g in jgroups]
    assert [r for g in groups for r in g.requests] == reqs
    for g in groups:
        assert g.total_tokens <= g.bucket <= 64 and len(g.requests) <= 4
        assert g.bucket == max(prefill.next_pow2(g.total_tokens), 8)
    if pack:
        assert [len(g.requests) for g in groups[:2]] == [4, 4]
        assert groups[0].bucket == 32
    else:
        assert all(len(g.requests) == 1 for g in groups)


def test_replay_page_counts_match_jax():
    rng = np.random.RandomState(1)
    lens = [12, 5, 17, 1]
    tables = rng.permutation(40)[:4 * 3].reshape(4, 3).astype(np.int32)
    got = prefill.replay_page_counts(lens, tables, 8, 40)
    want = jprefill.replay_page_counts(lens, tables, 8, 40)
    for a, b in zip(got, want):
        assert_same(a, b)
    assert got[1].sum() == sum(lens)


# =============================================================================
# prefill against prompt replay, within the port
# =============================================================================

def test_prefill_matches_replay_in_port(models):
    ref, rr = _port(models, PROMPTS, reference=True)
    pre, rp = _port(models, PROMPTS, prefill=True, decode_block=4)
    _assert_replay_parity(ref, pre, rr, rp)
    assert int(pre.sysmon.sample_idx) < int(ref.sysmon.sample_idx)


def test_packed_prefill_matches_replay_and_unpacked(models):
    ref, rr = _port(models, SHORT, max_new=3, reference=True)
    pk, rpk = _port(models, SHORT, max_new=3, prefill=True, decode_block=4)
    _assert_replay_parity(ref, pk, rr, rpk)
    solo, rsolo = _port(models, SHORT, max_new=3, prefill=True,
                        prefill_pack=False, decode_block=4)
    _assert_replay_parity(pk, solo, rpk, rsolo)
    jsolo, jrsolo = _jax(models, SHORT, max_new=3, prefill=True,
                         prefill_pack=False, decode_block=4)
    assert [r.generated for r in rsolo] == [r.generated for r in jrsolo]
    for f in SYSMON_FIELDS:
        assert_same(getattr(solo.sysmon, f), getattr(jsolo.sysmon, f))
    assert len(prefill.pack_prompts([_FakeReq(len(p)) for p in SHORT],
                                    min_bucket=16, max_bucket=128)) == 1


# =============================================================================
# the port's prefill engine against the JAX prefill engine
# =============================================================================

@pytest.mark.parametrize("memos", [False, True])
def test_prefill_engine_matches_jax(models, memos):
    kw = dict(prefill=True, decode_block=4)
    if memos:
        # 5 HBM slots for three sequences: preemption, demotion and
        # promotion happen around the prefill dispatches
        kw.update(memos_enabled=True, memos_interval=4, fast_slots=5)
    prompts = PROMPTS if not memos else [PROMPTS[0], [21, 22, 23],
                                         list(range(50, 59))]
    jeng, jreqs = _jax(models, prompts, **kw)
    teng, treqs = _port(models, prompts, **kw)
    for j, t in zip(jreqs, treqs):
        assert t.generated == j.generated
        assert t.tokens == j.tokens
        assert (t.first_token_step, t.finish_step) == \
            (j.first_token_step, j.finish_step)
    for f in SYSMON_FIELDS:
        assert_same(getattr(teng.sysmon, f), getattr(jeng.sysmon, f))
    ts, js = teng.kv.store, jeng.kv.store
    for f in ("tier", "slot", "version"):
        assert_same(getattr(ts, f), getattr(js, f))
    assert ts.traffic == js.traffic
    assert (ts.writes_to, ts.reads_from) == (js.writes_to, js.reads_from)
    assert_same(ts.wear.wear_counts(), js.wear.wear_counts())
    assert len(teng.memos.reports) == len(jeng.memos.reports)
    if memos:
        assert teng.memos.reports and ts.traffic[(0, 1)] > 0
        assert teng.memos.engine.stats.to_dict() == \
            jeng.memos.engine.stats.to_dict()
    assert_close(ts.fast_pool, np.asarray(js.fast_pool))
    assert_close(teng.last_logits, np.asarray(jeng.last_logits))


def test_prefill_dispatch_goes_through_the_kernels(models, monkeypatch):
    """The three short prompts pack into one bucket-16 dispatch: per
    layer one fused qk-norm + RoPE + KV append and one call of K1's
    prefill entry over the bucket's 16 rows, and the prefill metrics
    count it."""
    obs.reset()
    tcfg, tparams, _, _ = models
    eng = PagedServingEngine(tcfg, tparams, ServeConfig(
        **BASE, prefill=True, decode_block=4), device="cpu")
    for p in SHORT:
        eng.submit(p, 3)
    calls = []

    def spy(name, fn, rows_arg):
        def wrapped(*a):
            calls.append((name, a[rows_arg].shape[0]))
            return fn(*a)
        monkeypatch.setattr(prefill, name, wrapped)
    spy("rope_append", prefill.rope_append, 0)
    spy("paged_attention_prefill_pooled",
        prefill.paged_attention_prefill_pooled, 0)
    eng.step()
    assert calls == [("rope_append", 16),
                     ("paged_attention_prefill_pooled", 16)] * tcfg.n_layers
    reg = obs.get_registry()
    assert reg.counter("serving.prefill_dispatches").value == 1
    assert reg.counter("serving.prefill_tokens").value == 15
    obs.reset()


# =============================================================================
# the dual-pool prefill
# =============================================================================

N_FAST, N_PIN, PAGE = 6, 10, 4


def test_core_pinned_matches_jax(models):
    """Two packed segments whose pages split between the tier-0 pool and
    the pinned pool, with a non-identity remap and a numeric slot
    collision between the pools: both pools, the first tokens and the
    segment logits against JAX ``PrefillRunner._core_pinned``."""
    tcfg, tparams, jcfg, jparams = models
    scfg = dict(page_size=PAGE, max_batch=3, fast_slots=N_FAST,
                slow_slots=N_PIN, max_pages_per_seq=4, prefill=True)
    jeng = JEngine(jcfg, jparams, JServeConfig(
        **scfg, hierarchy=jhierarchy.MemoryHierarchy.two_tier(N_FAST,
                                                              N_PIN)))
    teng = PagedServingEngine(tcfg, tparams, ServeConfig(
        **scfg, hierarchy=MemoryHierarchy.two_tier(N_FAST, N_PIN,
                                                   pinned_slow=True)),
        device="cpu")
    rng = np.random.RandomState(SEED + 1)
    fast = (rng.standard_normal(tuple(teng.kv.store.fast_pool.shape))
            * 0.5).astype(np.float32)
    pin = (rng.standard_normal(tuple(teng.kv.store.pools[1].data.shape))
           * 0.5).astype(np.float32)
    teng.kv.store.fast_pool.copy_(torch.from_numpy(fast))
    teng.kv.store.pools[1].data.copy_(torch.from_numpy(pin))
    group = prefill.PackedGroup(bucket=16, requests=[
        _FakeReq(7), _FakeReq(6)])
    for r in group.requests:
        r.prompt = rng.randint(0, tcfg.vocab, len(r.prompt)).tolist()
    bt = np.array([[2, 4, 0, 0], [2, 1, 0, 0]], np.int32)
    sel = np.array([[1, 0, 0, 0], [0, 1, 0, 0]], np.int32)
    remap = np.array([3, 0, 9, 1, 7, 2, 8, 4, 6, 5], np.int32)
    a = teng.prefill_runner.build_args(group, bt, sel)
    ja = jeng.prefill_runner.build_args(group, bt, sel)
    for k, v in a.items():
        assert_same(v, ja[k][:len(v)])
    first, seg_logits, _ = teng.prefill_runner._core_pinned(
        *(torch.from_numpy(a[k]) for k in (
            "tokens", "local_pos", "row_tables", "row_sel", "lengths",
            "write_slot", "write_sel", "write_off", "seg_last")),
        torch.from_numpy(remap))
    jfirst, jlogits, _, jfast, jpin = jax.jit(
        jeng.prefill_runner._core_pinned)(
        jparams, *(jnp.asarray(ja[k]) for k in (
            "tokens", "local_pos", "row_tables", "row_sel", "lengths",
            "write_slot", "write_sel", "write_off", "seg_last")),
        jnp.asarray(fast), jnp.asarray(pin), jnp.asarray(remap))
    assert_same(first, np.asarray(jfirst)[:2])
    assert_close(seg_logits, np.asarray(jlogits)[:2])
    for got, before, want in ((teng.kv.store.fast_pool, fast, jfast),
                              (teng.kv.store.pools[1].data, pin, jpin)):
        want = np.asarray(want)
        moved = want != before
        assert moved.any()
        assert_same(got.numpy() != before, moved)
        assert_close(got, want)


def _pinned_hier():
    return MemoryHierarchy.two_tier(2, 128, pinned_slow=True,
                                    gap_write_interval=10_000)


def test_pinned_prefill_matches_replay_including_wear(models):
    """Twin of ``test_pinned_prefill_parity_including_wear``: prompt KV
    lands in the pinned tier; against the port's K=1 dual-pool replay
    the tokens, counters, pools and the pinned tier's wear match, and
    the tokens equal the JAX numpy-host prefill engine's."""
    ref, rr = _port(models, PROMPTS, reference=True, fast_slots=2,
                    hierarchy=_pinned_hier())
    pre, rp = _port(models, PROMPTS, prefill=True, decode_block=4,
                    fast_slots=2, hierarchy=_pinned_hier())
    assert pre.pinned_tier == 1
    _assert_replay_parity(ref, pre, rr, rp)
    wr, wp = ref.kv.store.wear_by_tier[1], pre.kv.store.wear_by_tier[1]
    assert wr.writes_total == wp.writes_total > 0
    assert wr.leveling_writes == wp.leveling_writes
    assert_same(wp.wear_counts(), wr.wear_counts())
    assert_same(wp._remap, wr._remap)
    _, jreqs = _jax(models, PROMPTS, prefill=True, decode_block=4)
    assert [r.generated for r in rp] == [r.generated for r in jreqs]


# =============================================================================
# lifecycle edges
# =============================================================================

def test_submit_rejects_structurally(models):
    tcfg, tparams, jcfg, jparams = models
    kw = dict(page_size=8, max_batch=2, fast_slots=32, slow_slots=128,
              max_pages_per_seq=4, prefill=True, prefill_max_bucket=16)
    eng = PagedServingEngine(tcfg, tparams, ServeConfig(**kw), device="cpu")
    jeng = JEngine(jcfg, jparams, JServeConfig(**kw))
    assert eng.prefill_runner.max_bucket == jeng.prefill_runner.max_bucket
    for e, err in ((eng, CapacityError), (jeng, JCapacityError)):
        with pytest.raises(err):
            e.submit(list(range(30)), max_new=10)    # exceeds page budget
        with pytest.raises(err):
            e.submit(list(range(20)), max_new=2)     # exceeds max bucket
        e.submit(list(range(10)), max_new=2)


def test_max_new_one_finishes_at_prefill_boundary(models):
    prompts = [PROMPTS[0], [21, 22, 23]]
    eng, reqs = _port(models, prompts, max_new=1, prefill=True)
    _, jreqs = _jax(models, prompts, max_new=1, prefill=True)
    for r, j in zip(reqs, jreqs):
        assert r.generated == j.generated and len(r.generated) == 1
        assert r.done and not r.pages
        assert r.first_token_step == j.first_token_step is not None
    assert eng.kv.store.tier_used()[0] == 0


def test_prefill_ttft_stamped_at_admission_boundary(models):
    prompts = PROMPTS[:2]
    eng, reqs = _port(models, prompts, prefill=True, decode_block=4)
    for r in reqs:
        assert r.first_token_step == r.arrival == 0
        assert r.ttft_s is not None and r.ttft_s >= 0
    _, rref = _port(models, prompts, reference=True)
    for r in rref:
        assert r.first_token_step == len(r.prompt) - 1
