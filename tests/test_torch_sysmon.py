"""SysMon in the port against the JAX package: the same random event
streams (made with numpy) go through ``record`` / ``end_pass`` /
``remap`` in both, and every ``SysmonState`` and ``PassSummary`` field
must match exactly — they are integer counters and codes, plus the
float32 hotness key computed from them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_same, cap_threads
from repro.core import patterns as jpatterns
from repro.core import predictor as jpredictor
from repro.core import sysmon as jsysmon
from repro_torch.core import patterns, predictor, sysmon

cap_threads()

# the JAX side runs jitted, its write flag always a [k] array: dispatching
# each of its ops eagerly would dominate the test's time
_jrecord = jax.jit(lambda s, ids, w, v: jsysmon.record(s, ids, is_write=w,
                                                       valid=v))


def _stream(rng, n_pages, n_samplings):
    """Samplings of ragged id lists padded to one length (as the engine
    pads block tables): duplicates, a validity mask over a random
    prefix, mixed read/write flags, and now and then a whole-batch
    write."""
    k = 2 * n_pages
    for _ in range(n_samplings):
        ids = rng.randint(0, n_pages, size=k).astype(np.int32)
        ids[: int(rng.randint(0, k // 4))] = ids[0]
        valid = (rng.rand(k) < 0.85) & (np.arange(k) < rng.randint(1, k))
        if rng.rand() < 0.3:
            is_write = bool(rng.rand() < 0.5)
        else:
            is_write = rng.rand(k) < 0.3
        yield ids, is_write, valid


def _assert_state_equal(got, want):
    for f in jsysmon.SysmonState._fields:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert tuple(g.shape) == w.shape, f
        assert str(g.dtype).split(".")[-1] == w.dtype.name, f
        assert_same(g, w)


def _assert_summary_equal(got, want):
    for f in jsysmon.PassSummary._fields:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert str(g.dtype).split(".")[-1] == w.dtype.name, f
        assert_same(g, w)


@pytest.mark.parametrize("n_pages,n_banks,n_slabs,seed", [
    (50, 4, 3, 0), (7, 1, 1, 1), (200, 32, 16, 2)])
def test_sysmon_passes_match_jax(n_pages, n_banks, n_slabs, seed):
    """Several passes of random samplings: the state after every sampling
    and the summary of every pass, including the WD history the
    predictor feeds on across passes."""
    rng = np.random.RandomState(seed)
    js = jsysmon.init(n_pages, n_banks, n_slabs)
    ts = sysmon.init(n_pages, n_banks, n_slabs, device="cpu")
    _assert_state_equal(ts, js)
    for _ in range(10):
        for ids, is_write, valid in _stream(rng, n_pages,
                                            int(rng.randint(1, 9))):
            tw = is_write if isinstance(is_write, bool) else \
                torch.from_numpy(is_write)
            js = _jrecord(js, jnp.asarray(ids),
                          jnp.broadcast_to(jnp.asarray(is_write), ids.shape),
                          jnp.asarray(valid))
            ts = sysmon.record(ts, torch.from_numpy(ids), is_write=tw,
                               valid=torch.from_numpy(valid))
        _assert_state_equal(ts, js)
        js, jsum = jsysmon.end_pass(js)
        ts, tsum = sysmon.end_pass(ts)
        _assert_state_equal(ts, js)
        _assert_summary_equal(tsum, jsum)
        _assert_summary_equal(tsum.numpy(), jsum)
        assert sysmon.summary_metrics(tsum) == jsysmon.summary_metrics(jsum)


def test_sysmon_remap_matches_jax():
    """Moved pages take new bank/slab colors; later samplings fold
    through the new maps."""
    rng = np.random.RandomState(5)
    n = 40
    js = jsysmon.init(n, 4, 4)
    ts = sysmon.init(n, 4, 4, device="cpu")
    pages = rng.permutation(n)[:12].astype(np.int32)
    bank = rng.randint(0, 4, size=12).astype(np.int32)
    slab = rng.randint(0, 4, size=12).astype(np.int32)
    js = jsysmon.remap(js, jnp.asarray(pages), jnp.asarray(bank),
                       jnp.asarray(slab))
    ts = sysmon.remap(ts, torch.from_numpy(pages), torch.from_numpy(bank),
                      torch.from_numpy(slab))
    ids = rng.randint(0, n, size=60).astype(np.int32)
    js = jsysmon.record(js, jnp.asarray(ids), is_write=True)
    ts = sysmon.record(ts, torch.from_numpy(ids), is_write=True)
    _assert_state_equal(ts, js)


def test_apply_sampling_matches_jax_on_dense_increments():
    """``_apply_sampling`` on dense increments (the kernel's output form),
    with reuse gaps across samplings."""
    rng = np.random.RandomState(9)
    n = 30
    js = jsysmon.init(n, 2, 2)
    ts = sysmon.init(n, 2, 2, device="cpu")
    for _ in range(6):
        dr = rng.randint(0, 3, size=n).astype(np.int32)
        dw = rng.randint(0, 2, size=n).astype(np.int32)
        touched = ((dr + dw) > 0).astype(np.int32)
        js = jsysmon._apply_sampling(js, jnp.asarray(dr), jnp.asarray(dw),
                                     jnp.asarray(touched))
        ts = sysmon._apply_sampling(ts, torch.from_numpy(dr),
                                    torch.from_numpy(dw),
                                    torch.from_numpy(touched))
    _assert_state_equal(ts, js)


def test_predictor_and_patterns_match_jax_on_every_history():
    """All 256 uint8 histories through push_history / predict_future, and
    the pattern classifiers on random counters."""
    hist = np.arange(256, dtype=np.uint8)
    for bit in (0, 1):
        wd = np.full(256, bit, np.uint8)
        got = predictor.push_history(torch.from_numpy(hist),
                                     torch.from_numpy(wd))
        assert got.dtype == torch.uint8
        assert_same(got, jpredictor.push_history(jnp.asarray(hist),
                                                 jnp.asarray(wd)))
    assert_same(predictor.predict_future(torch.from_numpy(hist)),
                jpredictor.predict_future(jnp.asarray(hist)))
    assert_same(predictor.popcount8(torch.arange(1 << 16)),
                jpredictor.popcount8(jnp.arange(1 << 16)))
    rng = np.random.RandomState(4)
    n = 500
    reads = rng.randint(0, 20, n).astype(np.int32)
    writes = rng.randint(0, 20, n).astype(np.int32)
    writes[::7] = 0
    reads[::11] = 0
    acc = rng.randint(0, 12, n).astype(np.int32)
    cnt = rng.randint(0, 6, n).astype(np.int32)
    s = (cnt * rng.randint(1, 8, n)).astype(np.int32)
    sq = (s * rng.randint(1, 8, n)).astype(np.int32)
    t = {k: torch.from_numpy(v) for k, v in
         dict(reads=reads, writes=writes, acc=acc, cnt=cnt, s=s,
              sq=sq).items()}
    assert_same(patterns.classify_wd(t["reads"], t["writes"]),
                jpatterns.classify_wd(jnp.asarray(reads),
                                      jnp.asarray(writes)))
    for samples in (0, 1, 10):
        assert_same(patterns.classify_hot(t["acc"], torch.tensor(samples)),
                    jpatterns.classify_hot(jnp.asarray(acc),
                                           jnp.int32(samples)))
        assert_same(patterns.classify_reuse(t["cnt"], t["s"], t["sq"],
                                            torch.tensor(samples)),
                    jpatterns.classify_reuse(jnp.asarray(cnt), jnp.asarray(s),
                                             jnp.asarray(sq),
                                             jnp.int32(samples)))
    assert_same(patterns.hotness_score(t["acc"], t["writes"]),
                jpatterns.hotness_score(jnp.asarray(acc),
                                        jnp.asarray(writes)))
