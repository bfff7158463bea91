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
from repro_torch.kernels import kv_append as KA
from repro_torch.kernels import page_checksum as K5
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


@pytest.mark.parametrize("write", [True, "one"])
def test_touch_update_broadcasts_one_element_masks(write):
    """A one-element ``valid`` and ``is_write`` tensor apply to every
    event, as the JAX op broadcasts them."""
    jnp = _jnp()
    from repro.kernels.hotness_update import touch_update
    ids = np.array([3, 3, 0, 7, 9, -1], np.int32)
    valid = np.array([True])
    is_write = np.array([True]) if write == "one" else write
    got = K2.touch_update(
        8, torch.from_numpy(ids),
        is_write if isinstance(is_write, bool) else torch.from_numpy(
            is_write), torch.from_numpy(valid))
    jw = is_write if isinstance(is_write, bool) else jnp.asarray(is_write)
    want = touch_update(8, jnp.asarray(ids), jw, jnp.asarray(valid))
    for g, w in zip(got, want):
        assert_same(g, w)


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


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n_pages", [512, 5000, 70000])
@pytest.mark.parametrize("k", [1, 37, 4096])
def test_touch_update_owner_computes_cuda(n_pages, k):
    """The owner-computes kernel, one CTA per 2048 pages, exact against
    the plain version: explicit weights, and SysMon's form (raw ids with
    duplicates and out-of-range entries, a ``valid`` mask, ``is_write`` as
    a vector and as a flag) against the CPU path's normalisation.  Each
    call is one launch."""
    dev = cuda_device()
    rng = np.random.RandomState(n_pages + k)
    ids_np = rng.randint(-5, n_pages + 5, size=k).astype(np.int32)
    ids_np[: k // 3] = ids_np[0]                          # duplicates
    ids_np[-1] = n_pages - 1                              # the last page
    valid = torch.from_numpy(rng.rand(k) < 0.8)
    is_write = torch.from_numpy(rng.rand(k) < 0.4)
    clipped = torch.from_numpy(np.clip(ids_np, 0, n_pages - 1))
    r = torch.from_numpy((rng.rand(k) < .5).astype(np.int32))
    w = torch.from_numpy((rng.rand(k) < .3).astype(np.int32))
    ids = torch.from_numpy(ids_np)
    n0 = kernels.launch_counts()["touch_update"]
    got = [K2.touch_update_events(n_pages, clipped.to(dev), r.to(dev),
                                  w.to(dev)),
           K2.touch_update(n_pages, ids.to(dev), is_write.to(dev),
                           valid.to(dev)),
           K2.touch_update(n_pages, ids.to(dev), True, valid.to(dev)),
           K2.touch_update(n_pages, ids.to(dev), False)]
    torch.cuda.synchronize()
    assert kernels.launch_counts()["touch_update"] == n0 + 4
    want = [K2.touch_update_plain(n_pages, clipped, r, w),
            K2.touch_update(n_pages, ids, is_write, valid),
            K2.touch_update(n_pages, ids, True, valid),
            K2.touch_update(n_pages, ids, False)]
    for g3, w3 in zip(got, want):
        for g, p in zip(g3, w3):
            assert g.dtype == torch.int32 and g.shape == (n_pages,)
            assert_same(g, p)


@pytest.mark.requires_cuda
def test_touch_update_empty_sampling_launches_nothing_cuda():
    """k = 0 through SysMon's entry: zeros, and no launch counted."""
    dev = cuda_device()
    n0 = kernels.launch_counts()["touch_update"]
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    out = K2.touch_update(512, none, True,
                          torch.zeros(0, dtype=torch.bool, device=dev))
    assert all(int(t.abs().sum()) == 0 and t.shape == (512,) for t in out)
    assert kernels.launch_counts()["touch_update"] == n0


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


# =============================================================================
# K5 page checksum
# =============================================================================

def _pool_of(dtype, shape, seed):
    """A pool with values spread over the dtype's range (int8 wraps)."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal(shape) * 64
    if dtype == torch.int8:
        return torch.from_numpy(x.astype(np.int64).astype(np.int8))
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_page_checksum_plain_vs_jax(dtype):
    """Exact: the plain version against the JAX numpy ``checksum_np`` and
    jnp ``page_checksum_ref`` over the same stored bits (bf16 as its
    uint16 pattern), including repeated slots."""
    jnp = _jnp()
    import jax
    from repro.kernels.page_checksum import checksum_np, page_checksum_ref
    pool = _pool_of(dtype, (7, 3, 4, 5), seed=4)
    idx = np.array([6, 0, 3, 3, 1], np.int32)
    got = K5.page_checksum(pool, torch.from_numpy(idx))
    assert got.dtype == torch.uint32
    raw = (pool.view(torch.int16).numpy().view(np.uint16)
           if dtype == torch.bfloat16 else pool.numpy())
    assert_same(got, checksum_np(raw[idx]))
    assert_same(got, K5.checksum_np(raw[idx]))
    jpool = (jax.lax.bitcast_convert_type(jnp.asarray(raw), jnp.bfloat16)
             if dtype == torch.bfloat16 else jnp.asarray(raw))
    assert_same(got, page_checksum_ref(jpool[jnp.asarray(idx)]))


def test_page_checksum_full_depth_weights_fit():
    """A full-depth qwen3_4b page (36 x 2 x 16 x 8 x 128 bf16) at its
    largest stored value: the int64 plain sum stays exact mod 2**32."""
    n = 36 * 2 * 16 * 8 * 128
    assert 2 * n + 1 < 2 ** 32
    pool = torch.full((1, n), -1, dtype=torch.int16).view(torch.bfloat16)
    got = int(K5.page_checksum(pool, torch.tensor([0], dtype=torch.int32)))
    assert got == int(K5.checksum_np(np.full((1, n), 0xFFFF, np.uint16))[0])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("pinned", [False, True])
def test_page_checksum_kernel_vs_plain_cuda(dtype, pinned):
    """Exact, on a full-depth KV page shape plus a ragged one, from HBM
    and from pinned host memory read in place."""
    dev = cuda_device()
    for shape in ((5, 36, 2, 16, 8, 128), (6, 3, 7)):
        pool = _pool_of(dtype, shape, seed=5)
        pool = pool.pin_memory() if pinned else pool.to(dev)
        idx = torch.tensor([4, 0, 2, 2], dtype=torch.int32, device=dev)
        n0 = kernels.launch_counts()["page_checksum"]
        got = K5.page_checksum(pool, idx)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["page_checksum"] == n0 + 1
        assert_same(got.cpu().numpy(),
                    K5.page_checksum_plain(pool.cpu(), idx.cpu()).numpy())


# =============================================================================
# K7 sysmon pass
# =============================================================================

def test_sysmon_pass_plain_vs_jax():
    """Exact: every history byte crossed with cold/RD/WD counters,
    against ``sysmon_pass_ref`` and the Pallas kernel in interpret
    mode."""
    jnp = _jnp()
    from repro.kernels.hotness_update import sysmon_pass, sysmon_pass_ref
    hist = np.tile(np.arange(256, dtype=np.int32), 4)
    rng = np.random.RandomState(6)
    reads = rng.randint(0, 5, hist.size).astype(np.int32)
    writes = rng.randint(0, 3, hist.size).astype(np.int32)
    reads[:256] = writes[:256] = 0                       # untouched: COLD
    got = K2.sysmon_pass(torch.from_numpy(reads), torch.from_numpy(writes),
                         torch.from_numpy(hist))
    args = (jnp.asarray(reads), jnp.asarray(writes), jnp.asarray(hist))
    for want in (sysmon_pass_ref(*args),
                 sysmon_pass(*args, interpret=True, block=256)):
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            assert_same(g, w)


@pytest.mark.requires_cuda
def test_sysmon_pass_kernel_vs_plain_cuda():
    dev = cuda_device()
    rng = np.random.RandomState(7)
    n = 5000
    args = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
        rng.randint(0, 9, n), rng.randint(0, 5, n), rng.randint(0, 256, n))]
    n0 = kernels.launch_counts()["sysmon_pass"]
    got = K2.sysmon_pass(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sysmon_pass"] == n0 + 1
    for g, p in zip(got, K2.sysmon_pass_plain(*args)):
        assert_same(g, p)


# =============================================================================
# K1 dual-pool variant and the KV append
# =============================================================================

def _dual_inputs(seed, B=3, Hq=8, Hkv=2, D=16, page=4, P=3, n_fast=6,
                 n_pin=9, layers=2):
    rng = np.random.RandomState(seed)
    fast = rng.standard_normal((n_fast, layers, 2, page, Hkv, D)
                               ).astype(np.float32)
    pin = rng.standard_normal((n_pin, layers, 2, page, Hkv, D)
                              ).astype(np.float32)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    sel = (rng.rand(B, P) < 0.5).astype(np.int32)
    sel[0, 0], sel[1, 0] = 1, 0
    bt = np.where(sel > 0, rng.randint(0, n_pin, (B, P)),
                  rng.randint(0, n_fast, (B, P))).astype(np.int32)
    bt[0, 0] = bt[1, 0] = 2                       # one slot number, two pools
    lengths = rng.randint(1, P * page + 1, B).astype(np.int32)
    lengths[0] = P * page
    return fast, pin, q, bt, sel, lengths


def test_paged_attention_dual_plain_vs_jax():
    """The dual-pool plain version against the JAX dual gather + select
    and ``paged_attention_pages`` (atol 1e-5, rtol 1e-4), and against
    single-pool K1 when every page sits in one pool (exact)."""
    jnp = _jnp()
    from repro.kernels.paged_attention import paged_attention_pages
    fast, pin, q, bt, sel, lengths = _dual_inputs(8)
    tf, tp = torch.from_numpy(fast), torch.from_numpy(pin)
    l = 1
    got = K1.paged_attention_dual(
        torch.from_numpy(q), tf[:, l, 0], tf[:, l, 1], tp[:, l, 0],
        tp[:, l, 1], torch.from_numpy(bt), torch.from_numpy(sel),
        torch.from_numpy(lengths))
    jb = jnp.asarray(bt)
    sp = jnp.asarray(sel > 0)[:, :, None, None, None]
    jf, jp = jnp.asarray(fast), jnp.asarray(pin)
    k = jnp.where(sp, jp[jb, l, 0], jf[jb, l, 0])
    v = jnp.where(sp, jp[jb, l, 1], jf[jb, l, 1])
    assert_close(got, paged_attention_pages(jnp.asarray(q), k, v,
                                            jnp.asarray(lengths)))
    btf = np.minimum(bt, fast.shape[0] - 1)
    single = K1.paged_attention(
        torch.from_numpy(q), tf[:, l, 0], tf[:, l, 1],
        torch.from_numpy(btf), torch.from_numpy(lengths))
    dual = K1.paged_attention_dual(
        torch.from_numpy(q), tf[:, l, 0], tf[:, l, 1], tp[:, l, 0],
        tp[:, l, 1], torch.from_numpy(btf), torch.zeros_like(
            torch.from_numpy(sel)), torch.from_numpy(lengths))
    assert_same(dual, single)


def test_kv_append_plain_vs_jax_drop_scatter():
    """Pinned tail, fast tail, and an out-of-range slot in the pool that
    does not hold the tail, against the JAX ``mode="drop"`` scatters
    (exact: the same values are stored)."""
    jnp = _jnp()
    rng = np.random.RandomState(9)
    fast, pin, *_ = _dual_inputs(9)
    n_fast, n_pin = fast.shape[0], pin.shape[0]
    Hkv, D = fast.shape[4:]
    k = rng.standard_normal((3, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((3, Hkv, D)).astype(np.float32)
    sel_tail = np.array([True, False, True])
    slot = np.array([2, 2, 8], np.int32)              # collides across pools
    off = np.array([3, 0, 1], np.int32)
    f_idx = np.where(sel_tail, n_fast, slot).astype(np.int32)
    p_idx = np.where(sel_tail, slot, n_pin).astype(np.int32)
    l = 1
    tf, tp = torch.from_numpy(fast.copy()), torch.from_numpy(pin.copy())
    KA.kv_append(tf[:, l], tp[:, l], torch.from_numpy(f_idx),
                 torch.from_numpy(p_idx), torch.from_numpy(off),
                 torch.from_numpy(k), torch.from_numpy(v))
    jf, jp = jnp.asarray(fast), jnp.asarray(pin)
    jf = jf.at[f_idx, l, 0, off].set(k, mode="drop")
    jf = jf.at[f_idx, l, 1, off].set(v, mode="drop")
    jp = jp.at[p_idx, l, 0, off].set(k, mode="drop")
    jp = jp.at[p_idx, l, 1, off].set(v, mode="drop")
    assert_same(tf, jf)
    assert_same(tp, jp)
    assert not np.array_equal(tp.numpy(), pin)      # pinned rows written


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_paged_attention_dual_kernel_vs_plain_cuda(dtype, tol):
    """The dual-pool kernel with its second pool in pinned host memory:
    within ``tol`` of the plain version, and bit-identical to
    single-pool K1 over the same pages moved into one HBM pool."""
    dev = cuda_device()
    fast, pin, q, bt, sel, lengths = _dual_inputs(10, B=4, Hq=32, Hkv=8,
                                                  D=128, page=16, P=5,
                                                  n_fast=12, n_pin=20)
    tf = torch.from_numpy(fast).to(dev, dtype)
    tp = torch.from_numpy(pin).to(dtype).pin_memory()
    qd = torch.from_numpy(q).to(dev, dtype)
    btd, seld = (torch.from_numpy(a).to(dev) for a in (bt, sel))
    ld = torch.from_numpy(lengths).to(dev)
    l = 1
    n0 = kernels.launch_counts()["paged_attention_dual"]
    got = K1.paged_attention_dual(qd, tf[:, l, 0], tf[:, l, 1], tp[:, l, 0],
                                  tp[:, l, 1], btd, seld, ld)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_attention_dual"] == n0 + 1
    tpd = tp.to(dev)
    want = K1.paged_attention_dual(qd.cpu(), tf.cpu()[:, l, 0],
                                   tf.cpu()[:, l, 1], tp[:, l, 0],
                                   tp[:, l, 1], btd.cpu(), seld.cpu(),
                                   ld.cpu())
    assert_close(got.float().cpu(), want.float(), atol=tol, rtol=tol)
    # the same pages moved into one pool: single-pool K1 gives the same bits
    merged = torch.cat([tf, tpd])
    btm = torch.where(seld > 0, btd + tf.shape[0], btd).to(torch.int32)
    single = K1.paged_attention(qd, merged[:, l, 0], merged[:, l, 1], btm, ld)
    torch.cuda.synchronize()
    assert_same(got.float(), single.float())


def test_new_wrappers_on_cpu_never_launch_or_build():
    """The slice's wrappers take their plain versions for CPU tensors:
    no launch is counted and nothing is built."""
    from repro_torch.kernels import _build
    kernels.reset_launch_counts()
    fast, pin, q, bt, sel, lengths = _dual_inputs(12)
    tf, tp = torch.from_numpy(fast), torch.from_numpy(pin)
    K1.paged_attention_dual(torch.from_numpy(q), tf[:, 0, 0], tf[:, 0, 1],
                            tp[:, 0, 0], tp[:, 0, 1], torch.from_numpy(bt),
                            torch.from_numpy(sel), torch.from_numpy(lengths))
    z = torch.zeros(3, dtype=torch.int32)
    KA.kv_append(tf[:, 0], tp[:, 0], z, z, z, torch.zeros(3, 2, 16),
                 torch.zeros(3, 2, 16))
    K5.page_checksum(tp, z)
    K2.sysmon_pass(z, z, z)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    assert _build._lib is None
