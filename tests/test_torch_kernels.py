"""The port's kernel modules against the JAX package's Pallas kernels.

Each plain PyTorch version (what the wrapper runs on CPU tensors) is held
against the JAX Pallas kernel in interpret mode and against its jnp/numpy
reference, on inputs made with numpy: duplicates, masked and
out-of-range ids, pow2-repeat indices, untouched slots, ragged lengths
and the strided per-layer pool view the engine passes.  The
``requires_cuda`` cases compare each CUDA kernel with its plain version
on the card and skip here.

JAX is imported inside the tests that use it, so the CUDA cases also
collect on a machine that has only torch.
"""
import numpy as np
import pytest
import torch

from helpers.torch_parity import (assert_close, assert_same, cap_threads,
                                  cuda_device)
from repro_torch import kernels
from repro_torch.kernels import hotness_update as K2
from repro_torch.kernels import page_gather as K3
from repro_torch.kernels import paged_attention as K1
from repro_torch.kernels import wear_update as K4

cap_threads()


def _jnp():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    return jnp


# =============================================================================
# K1 paged decode attention
# =============================================================================

def _attn_inputs(B, Hq, Hkv, D, page, n_pages, n_slots, seed, layers=3):
    """A [slots, L, 2, page, Hkv, D] pool and a decode batch whose block
    tables point at distinct slots with ragged lengths (filler slots past
    each row's live pages)."""
    rng = np.random.RandomState(seed)
    pool = rng.standard_normal((n_slots, layers, 2, page, Hkv, D)
                               ).astype(np.float32)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    bt = np.stack([rng.permutation(n_slots)[:n_pages]
                   for _ in range(B)]).astype(np.int32)
    lengths = rng.randint(1, n_pages * page + 1, size=B).astype(np.int32)
    lengths[0] = n_pages * page          # one full row
    lengths[-1] = page                   # one row ending on a page edge
    return pool, q, bt, lengths


@pytest.mark.parametrize("B,Hq,Hkv,D,page,n_pages", [
    (2, 4, 2, 32, 4, 3), (3, 8, 2, 16, 8, 2), (1, 4, 4, 32, 4, 4)])
def test_paged_attention_plain_vs_pallas(B, Hq, Hkv, D, page, n_pages):
    """The engine-facing wrapper on a strided per-layer pool view against
    the Pallas kernel (interpret mode) and the jnp reference."""
    jnp = _jnp()
    from repro.kernels.paged_attention import paged_attention as jpa
    pool, q, bt, lengths = _attn_inputs(B, Hq, Hkv, D, page, n_pages,
                                        n_slots=12, seed=B + D)
    layer = 1
    tpool = torch.from_numpy(pool)
    got = K1.paged_attention(torch.from_numpy(q), tpool[:, layer, 0],
                             tpool[:, layer, 1], torch.from_numpy(bt),
                             torch.from_numpy(lengths))
    args = (jnp.asarray(q), jnp.asarray(pool[:, layer, 0]),
            jnp.asarray(pool[:, layer, 1]), jnp.asarray(bt),
            jnp.asarray(lengths))
    assert_close(got, jpa(*args, interpret=True))
    assert_close(got, jpa(*args))                      # XLA reference path


def test_paged_attention_pooled_matches_ref():
    """Pre-scaled q through ``paged_attention_pooled`` against
    ``paged_attention_ref`` — the kernel's own signature."""
    jnp = _jnp()
    from repro.kernels.paged_attention import paged_attention_ref
    B, Hkv, G, D, page = 3, 2, 4, 16, 4
    pool, _, bt, lengths = _attn_inputs(B, Hkv * G, Hkv, D, page, 3,
                                        n_slots=9, seed=5, layers=1)
    qg = np.random.RandomState(6).standard_normal(
        (B, Hkv, G, D)).astype(np.float32)
    got = K1.paged_attention_pooled(
        torch.from_numpy(qg), torch.from_numpy(pool[:, 0, 0]),
        torch.from_numpy(pool[:, 0, 1]), torch.from_numpy(bt),
        torch.from_numpy(lengths))
    want = paged_attention_ref(jnp.asarray(qg), jnp.asarray(pool[:, 0, 0]),
                               jnp.asarray(pool[:, 0, 1]), jnp.asarray(bt),
                               jnp.asarray(lengths))
    assert_close(got, want)


def test_paged_attention_ignores_pages_past_length():
    """Columns past ceil(length/page) hold filler slots: changing the
    data there must not change the output."""
    pool, q, bt, lengths = _attn_inputs(2, 4, 2, 16, 4, 4, n_slots=10,
                                        seed=3, layers=1)
    lengths[:] = 5                                   # two live pages
    t = torch.from_numpy(pool)
    args = (torch.from_numpy(q), t[:, 0, 0], t[:, 0, 1],
            torch.from_numpy(bt), torch.from_numpy(lengths))
    before = K1.paged_attention(*args)
    t[torch.from_numpy(bt[:, 2:].reshape(-1)).long()] = 1e4
    assert_same(K1.paged_attention(*args), before)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_paged_attention_kernel_vs_plain_cuda(dtype, tol):
    dev = cuda_device()
    pool, _, bt, lengths = _attn_inputs(4, 32, 8, 128, 16, 6, n_slots=32,
                                        seed=11, layers=3)
    tpool = torch.from_numpy(pool).to(dev, dtype)
    qg = torch.from_numpy(np.random.RandomState(12).standard_normal(
        (4, 8, 4, 128)).astype(np.float32) * 128 ** -0.5).to(dev, dtype)
    args = (qg, tpool[:, 2, 0], tpool[:, 2, 1],
            torch.from_numpy(bt).to(dev), torch.from_numpy(lengths).to(dev))
    n0 = kernels.launch_counts()["paged_attention"]
    got = K1.paged_attention_pooled(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_attention"] == n0 + 1
    assert_close(got.float(), K1.paged_attention_plain(*args).float(),
                 atol=tol, rtol=tol)


# =============================================================================
# K2 touch_update
# =============================================================================

@pytest.mark.parametrize("n,k,write", [(40, 64, "mixed"), (700, 300, True),
                                       (5, 33, False)])
def test_touch_update_vs_pallas_and_ref(n, k, write):
    """Duplicates add up, touched dedupes, out-of-range ids clip, masked
    events weigh nothing — against the Pallas kernel (interpret), the
    XLA path and the numpy oracle."""
    jnp = _jnp()
    from repro.kernels.hotness_update import touch_update, touch_update_ref
    rng = np.random.RandomState(n + k)
    ids = rng.randint(-3, n + 3, size=k).astype(np.int32)   # out of range
    ids[: k // 4] = ids[0]                                    # duplicates
    is_write = (rng.rand(k) < 0.4) if write == "mixed" else write
    valid = rng.rand(k) < 0.8
    got = K2.touch_update(
        n, torch.from_numpy(ids),
        is_write if isinstance(is_write, bool) else torch.from_numpy(is_write),
        torch.from_numpy(valid))
    want_np = touch_update_ref(n, ids, is_write, valid)
    jw = is_write if isinstance(is_write, bool) else jnp.asarray(is_write)
    for interpret in (True, None):
        want = touch_update(n, jnp.asarray(ids), jw, jnp.asarray(valid),
                            interpret=interpret, block=128)
        for g, w, r in zip(got, want, want_np):
            assert g.dtype == torch.int32
            assert_same(g, w)
            assert_same(g, r)


def test_touch_update_without_mask():
    from repro.kernels.hotness_update import touch_update_ref
    ids = np.array([3, 3, 0, 7, 3], np.int32)
    got = K2.touch_update(8, torch.from_numpy(ids), True)
    for g, r in zip(got, touch_update_ref(8, ids, True)):
        assert_same(g, r)


@pytest.mark.requires_cuda
def test_touch_update_kernel_vs_plain_cuda():
    dev = cuda_device()
    rng = np.random.RandomState(1)
    ids = torch.from_numpy(rng.randint(0, 512, 1000).astype(np.int32)).to(dev)
    r = torch.from_numpy((rng.rand(1000) < .5).astype(np.int32)).to(dev)
    w = torch.from_numpy((rng.rand(1000) < .3).astype(np.int32)).to(dev)
    n0 = kernels.launch_counts()["touch_update"]
    got = K2.touch_update_events(512, ids, r, w)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["touch_update"] == n0 + 1
    for g, p in zip(got, K2.touch_update_plain(512, ids, r, w)):
        assert_same(g, p)


# =============================================================================
# K3 page gather / scatter
# =============================================================================

@pytest.mark.parametrize("n_slots,k,shape", [(16, 5, (2, 2, 4, 2, 8)),
                                             (9, 8, (4,)), (33, 1, (3, 5))])
def test_page_gather_scatter_vs_pallas(n_slots, k, shape):
    """pow2-padded index vectors (repeating the last slot) through the
    Pallas kernels and the plain versions; slots outside idx stay
    untouched by the scatter."""
    jnp = _jnp()
    from repro.core.tiers import _pad_idx_np
    from repro.kernels.page_gather import page_gather, page_scatter
    rng = np.random.RandomState(n_slots + k)
    pool = rng.standard_normal((n_slots, *shape)).astype(np.float32)
    idx = _pad_idx_np(rng.permutation(n_slots)[:k]).astype(np.int32)
    pages = rng.standard_normal((idx.size, *shape)).astype(np.float32)
    pages[k:] = pages[k - 1]                  # repeats carry one page
    got = K3.page_gather(torch.from_numpy(pool), torch.from_numpy(idx))
    assert_same(got, page_gather(jnp.asarray(pool), jnp.asarray(idx),
                                 interpret=True))
    tpool = torch.from_numpy(pool.copy())
    out = K3.page_scatter(tpool, torch.from_numpy(idx),
                          torch.from_numpy(pages))
    assert out is tpool                                  # in place
    want = page_scatter(jnp.asarray(pool), jnp.asarray(idx),
                        jnp.asarray(pages), interpret=True)
    assert_same(tpool, want)
    untouched = np.setdiff1d(np.arange(n_slots), idx)
    assert_same(tpool[untouched], pool[untouched])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape,dtype", [((36, 2, 16, 8, 128), torch.bfloat16),
                                         ((3,), torch.float32)])
def test_page_gather_scatter_kernel_vs_plain_cuda(shape, dtype):
    """Vector path (16-byte multiples) and the byte loop (a 12-byte page)."""
    dev = cuda_device()
    rng = np.random.RandomState(2)
    pool = torch.from_numpy(rng.standard_normal((24, *shape)).astype(
        np.float32)).to(dev, dtype)
    idx = torch.tensor([5, 0, 17, 17], dtype=torch.int32, device=dev)
    counts = kernels.launch_counts()
    got = K3.page_gather(pool, idx)
    assert_same(got.float(), K3.page_gather_plain(pool, idx).float())
    pages = torch.from_numpy(rng.standard_normal((4, *shape)).astype(
        np.float32)).to(dev, dtype)
    pages[3] = pages[2]
    a, b = pool.clone(), pool.clone()
    K3.page_scatter(a, idx, pages)
    K3.page_scatter_plain(b, idx, pages)
    torch.cuda.synchronize()
    assert_same(a.float(), b.float())
    now = kernels.launch_counts()
    assert now["page_gather"] == counts["page_gather"] + 1
    assert now["page_scatter"] == counts["page_scatter"] + 1


# =============================================================================
# K4 wear_update
# =============================================================================

@pytest.mark.parametrize("n,k", [(64, 10), (300, 257), (5, 128)])
def test_wear_update_vs_pallas_and_eager(n, k):
    """Duplicates accumulate, zero amounts are no-ops, out-of-range ids
    clip, masked events zero; the eager 128-bucketing pads with
    zero-amount events — against the JAX eager wrapper (XLA), the Pallas
    kernel (interpret) on the same bucketed list, and the numpy oracle."""
    jnp = _jnp()
    from repro.kernels.wear_update import wear_update, wear_update_ref
    from repro.kernels.wear_update.wear_update import wear_update_pallas
    rng = np.random.RandomState(n * k)
    wear0 = rng.randint(0, 50, size=n).astype(np.int32)
    ids = rng.randint(-2, n + 2, size=k)
    ids[: k // 3] = ids[0]
    amount = rng.randint(0, 4, size=k)
    valid = rng.rand(k) < 0.9
    got = K4.wear_update(torch.from_numpy(wear0.copy()), ids, amount,
                         valid=valid)
    assert_same(got, wear_update(jnp.asarray(wear0), ids, amount,
                                 valid=valid))
    clipped = np.clip(ids, 0, n - 1)
    amt = np.where(valid, amount, 0)
    assert_same(got, wear_update_ref(wear0, clipped, amt))
    kpad = (-k) % 128
    pid = np.concatenate([clipped, np.zeros(kpad, np.int64)])
    pam = np.concatenate([amt, np.zeros(kpad, np.int64)])
    assert_same(got, wear_update_pallas(
        jnp.asarray(wear0), jnp.asarray(pid, jnp.int32),
        jnp.asarray(pam, jnp.int32), block=128, interpret=True))


def test_wear_update_in_place_and_empty():
    wear = torch.zeros(4, dtype=torch.int32)
    assert K4.wear_update(wear, np.array([1, 1, 3])) is wear
    assert wear.tolist() == [0, 2, 0, 1]
    assert K4.wear_update(wear, np.array([], np.int64)).tolist() == \
        [0, 2, 0, 1]


@pytest.mark.requires_cuda
def test_wear_update_kernel_vs_plain_cuda():
    dev = cuda_device()
    rng = np.random.RandomState(3)
    base = torch.from_numpy(rng.randint(0, 9, 512).astype(np.int32)).to(dev)
    ids = torch.from_numpy(rng.randint(0, 512, 256).astype(np.int32)).to(dev)
    amt = torch.from_numpy(rng.randint(0, 3, 256).astype(np.int32)).to(dev)
    n0 = kernels.launch_counts()["wear_update"]
    got = K4.wear_update_events(base.clone(), ids, amt)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["wear_update"] == n0 + 1
    assert_same(got, K4.wear_update_plain(base.clone(), ids, amt))


# =============================================================================
# wrappers
# =============================================================================

def test_cpu_tensors_never_launch_or_build():
    """CPU tensors take the plain versions: no launch is counted and the
    kernel library is never built."""
    from repro_torch.kernels import _build
    kernels.reset_launch_counts()
    pool, q, bt, lengths = _attn_inputs(1, 4, 2, 8, 4, 2, 4, seed=0,
                                        layers=1)
    t = torch.from_numpy(pool)
    K1.paged_attention(torch.from_numpy(q), t[:, 0, 0], t[:, 0, 1],
                       torch.from_numpy(bt), torch.from_numpy(lengths))
    K2.touch_update(8, torch.tensor([1, 2]), True)
    K3.page_gather(t, torch.tensor([0, 1], dtype=torch.int32))
    K4.wear_update(torch.zeros(4, dtype=torch.int32), np.array([0]))
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    assert _build._lib is None


@pytest.mark.requires_cuda
def test_empty_inputs_count_no_launch_cuda():
    """An empty event list, index vector or batch launches nothing, so no
    count rises and the outputs are the untouched inputs."""
    dev = cuda_device()
    counts = kernels.launch_counts()
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    pool = torch.ones((4, 2, 8), dtype=torch.bfloat16, device=dev)
    assert K3.page_gather(pool, none).shape == (0, 2, 8)
    assert K3.page_scatter(pool, none, pool[:0]) is pool
    assert all(int(t.sum()) == 0 for t in K2.touch_update_events(
        6, none, none, none))
    wear = torch.arange(5, dtype=torch.int32, device=dev)
    assert K4.wear_update_events(wear, none, none).tolist() == [0, 1, 2, 3, 4]
    kv = torch.ones((4, 2, 1, 8), dtype=torch.bfloat16, device=dev)
    q = torch.ones((0, 1, 1, 8), dtype=torch.bfloat16, device=dev)
    out = K1.paged_attention_pooled(q, kv, kv, none.reshape(0, 2),
                                    none[:0])
    torch.cuda.synchronize()
    assert out.shape == (0, 1, 1, 8)
    assert kernels.launch_counts() == counts
