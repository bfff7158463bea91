"""The host-side functions of the JAX package that the port had left out,
against their JAX counterparts on the same numpy inputs, exactly (the
one float, ``bank_imbalance``'s std, within one float32 ulp):
``core.predictor.is_reverse`` and ``predict_trace`` (a Python loop where
JAX scans), ``core.patterns.bank_imbalance``, ``nvm.wear.record_writes``
(through the ``wear_update`` wrapper) and ``PagedKVCache.is_resident`` /
``write_token_kv`` on a device page and a numpy host page (pages,
versions, per-tier write counts and wear counters); the pinned-host
tier's token write against the same writes to a numpy host tier (the
JAX package's pinned pool aborts on this CPU, ROADMAP C1).  On a card,
``record_writes`` launches K4 once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_same, cap_threads, cuda_device
from repro.core import patterns as jpatterns
from repro.core import predictor as jpredictor
from repro.core.hierarchy import MemoryHierarchy as JHierarchy
from repro.nvm import wear as jwear
from repro.serving.kv_cache import PagedKVCache as JKV
from repro.serving.kv_cache import PagedKVConfig as JKVConfig
from repro_torch import kernels
from repro_torch.core import patterns, predictor
from repro_torch.core.hierarchy import MemoryHierarchy
from repro_torch.nvm import wear
from repro_torch.serving.kv_cache import PagedKVCache, PagedKVConfig

cap_threads()


@pytest.mark.parametrize("window_len,k_len", [(8, 3), (6, 2), (10, 4)])
def test_is_reverse_matches_jax_on_every_history(window_len, k_len):
    hist = np.arange(1 << window_len, dtype=np.int32)
    got = predictor.is_reverse(torch.from_numpy(hist),
                               window_len=window_len, k_len=k_len)
    want = jpredictor.is_reverse(jnp.asarray(hist), window_len=window_len,
                                 k_len=k_len)
    assert got.dtype == torch.bool
    assert_same(got, np.asarray(want))
    assert got.any() and not got.all()


@pytest.mark.parametrize("T,pages,window_len,k_len,horizon,p",
                         [(40, 33, 8, 3, 1, 0.5), (60, 16, 10, 4, 3, 0.8),
                          (9, 8, 8, 3, 1, 0.5), (30, 5, 4, 2, 2, 0.2)])
def test_predict_trace_matches_jax(T, pages, window_len, k_len, horizon, p):
    """Predictions exactly, and the float32 accuracy bit for bit (a mean
    of 0/1 values); a trace no longer than the warm-up scores 0."""
    rng = np.random.RandomState(T + pages)
    # persistent per-page phases plus noise, so both WD states occur
    base = rng.rand(pages) < p
    wd = (base[None, :] ^ (rng.rand(T, pages) < 0.15)).astype(np.int8)
    preds, acc = predictor.predict_trace(torch.from_numpy(wd),
                                         window_len=window_len, k_len=k_len,
                                         horizon=horizon)
    jpreds, jacc = jpredictor.predict_trace(jnp.asarray(wd),
                                            window_len=window_len,
                                            k_len=k_len, horizon=horizon)
    assert preds.dtype == torch.int8 and preds.shape == (T, pages)
    assert_same(preds, np.asarray(jpreds))
    assert acc.dtype == torch.float32
    assert float(acc) == float(jacc)
    if T <= horizon + window_len:
        assert float(acc) == 0.0


@pytest.mark.parametrize("banks,seed", [(8, 0), (16, 1), (64, 2), (1, 3),
                                        (12, 4), (120, 5)])
def test_bank_imbalance_matches_jax(banks, seed):
    freq = np.random.RandomState(seed).randint(0, 500, size=banks).astype(
        np.int32)
    got = patterns.bank_imbalance(torch.from_numpy(freq))
    want = jpatterns.bank_imbalance(jnp.asarray(freq))
    assert got.dtype == torch.float32
    # a float32 std: XLA sums the squares in another order, so the two
    # may round one ulp apart (2**-23 relative)
    np.testing.assert_allclose(float(got), float(want), rtol=2.4e-7, atol=0)
    assert float(got) == pytest.approx(float(np.std(freq)), rel=1e-6)


@pytest.mark.parametrize("with_amount,with_valid", [(False, False),
                                                    (True, False),
                                                    (True, True)])
def test_record_writes_matches_jax(with_amount, with_valid):
    rng = np.random.RandomState(4)
    n, k = 300, 517
    ids = rng.randint(0, n, size=k)
    amount = rng.randint(1, 9, size=k) if with_amount else None
    valid = rng.rand(k) < 0.7 if with_valid else None
    st = wear.init_wear(n, "cpu")
    jst = jwear.init_wear(n)
    for _ in range(2):                       # duplicates accumulate
        st = wear.record_writes(st, ids, amount, valid=valid)
        jst = jwear.record_writes(jst, ids, amount, valid=valid)
    assert_same(st.wear, np.asarray(jst.wear))
    assert_same(st.remap, np.asarray(jst.remap))


def _kvs(hier_t=None, hier_j=None):
    kw = dict(n_layers=2, n_kv_heads=2, head_dim=4, page_size=4,
              fast_slots=3, slow_slots=8)
    return (PagedKVCache(PagedKVConfig(hierarchy=hier_t, **kw),
                         device="cpu"),
            JKV(JKVConfig(hierarchy=hier_j, **kw)))


def _token_writes(kv, jkv, rng, pids, n):
    for _ in range(n):
        pid = int(rng.choice(pids))
        off = int(rng.randint(0, 4))
        kvv = rng.standard_normal((2, 2, 2, 4)).astype(np.float32)
        kv.write_token_kv(pid, torch.from_numpy(kvv), off)
        if jkv is not None:
            jkv.write_token_kv(pid, jnp.asarray(kvv), off)


def test_is_resident_and_write_token_kv_match_jax():
    """Pages bound beyond the 3 HBM slots cascade to the host tier: the
    resident flags, and after token writes to both kinds of page the
    pages, versions, per-tier write counts and host wear counters, equal
    the JAX cache's."""
    kv, jkv = _kvs()
    pids = [kv.new_page() for _ in range(6)]
    assert pids == [jkv.new_page() for _ in range(6)]
    res = [kv.is_resident(p) for p in pids]
    assert res == [jkv.is_resident(p) for p in pids] == [True] * 3 + \
        [False] * 3
    assert_same(kv.resident_mask(pids), np.asarray(res))
    kv.free_page(pids[1])
    jkv.free_page(pids[1])
    assert not kv.is_resident(pids[1]) and not jkv.is_resident(pids[1])
    live = [p for p in pids if p != pids[1]]
    _token_writes(kv, jkv, np.random.RandomState(5), live, 24)
    for p in live:
        np.testing.assert_array_equal(kv.store.read_page(p),
                                      jkv.store.read_page(p))
    assert_same(kv.store.version, np.asarray(jkv.store.version))
    assert kv.store.writes_to == jkv.store.writes_to
    assert_same(kv.store.wear_by_tier[1].wear_counts(),
                jkv.store.wear_by_tier[1].wear_counts())


def test_write_token_kv_pinned_tier_equals_numpy_host_tier():
    """The same token writes land the same in a pinned-host deepest tier
    (written in place in its physical row) as in a numpy host tier: the
    pages, versions, write counts and wear counters are equal; the JAX
    cache with the numpy tier agrees too."""
    hier = MemoryHierarchy.two_tier(3, 8, pinned_slow=True)
    pinned, jkv = _kvs(hier, JHierarchy.two_tier(3, 8))
    host, _ = _kvs()
    assert pinned.pinned_tier == 1 and host.pinned_tier is None
    pids = [pinned.new_page() for _ in range(6)]
    assert pids == [host.new_page() for _ in range(6)] == \
        [jkv.new_page() for _ in range(6)]
    _token_writes(pinned, jkv, np.random.RandomState(6), pids, 30)
    _token_writes(host, None, np.random.RandomState(6), pids, 30)
    for p in pids:
        np.testing.assert_array_equal(pinned.store.read_page(p),
                                      host.store.read_page(p))
        np.testing.assert_array_equal(pinned.store.read_page(p),
                                      jkv.store.read_page(p))
    assert_same(pinned.store.version, host.store.version)
    assert pinned.store.writes_to == host.store.writes_to
    assert_same(pinned.store.wear_by_tier[1].wear_counts(),
                host.store.wear_by_tier[1].wear_counts())
    assert pinned.store.wear_by_tier[1].wear_counts().sum() > 0


@pytest.mark.requires_cuda
def test_record_writes_launches_k4_on_the_card():
    dev = cuda_device()
    rng = np.random.RandomState(7)
    ids = rng.randint(0, 1000, size=4000)
    amount = rng.randint(1, 4, size=4000)
    st = wear.init_wear(1000, dev)
    before = kernels.launch_counts()["wear_update"]
    st = wear.record_writes(st, ids, amount)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["wear_update"] == before + 1
    ref = wear.record_writes(wear.init_wear(1000, "cpu"), ids, amount)
    assert st.wear.device.type == "cuda"
    assert_same(st.wear.cpu(), ref.wear)
