"""K1's prefill entries (``paged_attention_prefill``, ``_prefill_dual``)
and the redesigned decode body.

On the CPU the prefill wrappers run the plain versions, held against the
JAX ``paged_attention_prefill`` and ``paged_attention_prefill_pages``
(XLA reference path, atol 1e-5, rtol 1e-4) over packed buckets: ragged
segments that cross 64-row tiles, padding rows of length 0, and tables
that differ on every row.  The ``requires_cuda`` cases hold the CUDA
bodies against their plain versions (G 1-8, D 64-256, float32 and
bf16), the dual pool against the single pool bit for bit, and a row's
bits against its batch, its offset in the bucket and its neighbours;
they skip here.

JAX is imported inside the tests that use it, so the CUDA cases also
collect on a machine that has only torch.
"""
import numpy as np
import pytest
import torch

from helpers.torch_parity import (assert_close, assert_same, cap_threads,
                                  cuda_device)
from repro_torch import kernels
from repro_torch.configs.base import registry
from repro_torch.kernels import paged_attention as K1

cap_threads()

# packed buckets: (segment lengths, bucket rows, page, table width);
# padding rows fill the bucket past the segments
BUCKETS = {
    "packed_across_tiles": ((37, 90, 5), 160, 4, 23),
    "one_segment": ((150,), 160, 8, 19),
    "full_bucket": ((64, 64), 128, 4, 16),
}


def _jnp():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    return jnp


def _bucket(segs, L, page, Pp, *, n_slots=48, Hq=8, Hkv=2, D=16, seed=0,
            layers=2, all_different=False):
    """A pool [slots, layers, 2, page, Hkv, D], q [L, Hq, D] and per-row
    tables/lengths as ``PrefillRunner.build_args`` lays out a packed
    bucket: each segment's rows share its table and count 1..len; the
    padding rows have table 0 and length 0.  ``all_different`` gives
    every row its own table and a random length instead."""
    rng = np.random.RandomState(seed)
    pool = rng.standard_normal((n_slots, layers, 2, page, Hkv, D)
                               ).astype(np.float32)
    q = rng.standard_normal((L, Hq, D)).astype(np.float32)
    tables = np.zeros((L, Pp), np.int32)
    lengths = np.zeros(L, np.int32)
    off = 0
    for lp in segs:
        tables[off:off + lp] = rng.permutation(n_slots)[:Pp]
        lengths[off:off + lp] = np.arange(1, lp + 1)
        off += lp
    if all_different:
        tables = np.stack([rng.permutation(n_slots)[:Pp] for _ in range(L)]
                          ).astype(np.int32)
        lengths = rng.randint(0, Pp * page + 1, L).astype(np.int32)
        lengths[:3] = (0, 1, Pp * page)
    return pool, q, tables, lengths


def _selected(rng, tables, n_fast, n_pin, rows_share=None):
    """pool_sel for ``tables`` (about half the pages in the second pool,
    rows of one segment alike) and the tables re-drawn into each pool's
    range."""
    sel = (rng.rand(*tables.shape) < 0.5).astype(np.int32)
    if rows_share is not None:
        sel = sel[rows_share]
    return sel, np.where(sel > 0, tables % n_pin, tables % n_fast
                         ).astype(np.int32)


# =============================================================================
# CPU: the plain versions against the JAX package
# =============================================================================

@pytest.mark.parametrize("case", sorted(BUCKETS) + ["all_different"])
def test_prefill_plain_vs_jax(case):
    """One pool: the engine-facing prefill wrapper on a strided per-layer
    pool view against the JAX ``paged_attention_prefill``."""
    jnp = _jnp()
    from repro.kernels.paged_attention.ops import paged_attention_prefill
    segs, L, page, Pp = BUCKETS.get(case, BUCKETS["packed_across_tiles"])
    pool, q, tables, lengths = _bucket(segs, L, page, Pp, seed=len(case),
                                       all_different=case == "all_different")
    layer = 1
    t = torch.from_numpy(pool)
    got = K1.paged_attention_prefill(
        torch.from_numpy(q), t[:, layer, 0], t[:, layer, 1],
        torch.from_numpy(tables), torch.from_numpy(lengths))
    want = paged_attention_prefill(
        jnp.asarray(q), jnp.asarray(pool[:, layer, 0]),
        jnp.asarray(pool[:, layer, 1]), jnp.asarray(tables),
        jnp.asarray(lengths))
    assert got.shape == q.shape
    assert_close(got, want)


@pytest.mark.parametrize("case", sorted(BUCKETS) + ["all_different"])
def test_prefill_dual_plain_vs_jax(case):
    """Two pools: the dual prefill wrapper against the JAX gather +
    select and ``paged_attention_prefill_pages``; with every page in one
    pool it equals the single-pool prefill exactly."""
    jnp = _jnp()
    from repro.kernels.paged_attention.ops import (
        paged_attention_prefill_pages)
    segs, L, page, Pp = BUCKETS.get(case, BUCKETS["packed_across_tiles"])
    diff = case == "all_different"
    fast, q, tables, lengths = _bucket(segs, L, page, Pp, n_slots=30,
                                       seed=len(case) + 1,
                                       all_different=diff)
    pin = np.random.RandomState(2).standard_normal(
        (40,) + fast.shape[1:]).astype(np.float32)
    rng = np.random.RandomState(len(case))
    # rows of a segment share their table, so they share pool_sel too
    first = np.array([int(np.flatnonzero((tables == tables[i]).all(1))[0])
                      for i in range(L)])
    sel, bt = _selected(rng, tables, fast.shape[0], pin.shape[0],
                        None if diff else first)
    l = 1
    tf, tp = torch.from_numpy(fast), torch.from_numpy(pin)
    args = (torch.from_numpy(q), tf[:, l, 0], tf[:, l, 1], tp[:, l, 0],
            tp[:, l, 1])
    got = K1.paged_attention_prefill_dual(
        *args, torch.from_numpy(bt), torch.from_numpy(sel),
        torch.from_numpy(lengths))
    jb, sp = jnp.asarray(bt), jnp.asarray(sel > 0)[:, :, None, None, None]
    jf, jp = jnp.asarray(fast), jnp.asarray(pin)
    k = jnp.where(sp, jp[jb, l, 0], jf[jb, l, 0])
    v = jnp.where(sp, jp[jb, l, 1], jf[jb, l, 1])
    assert_close(got, paged_attention_prefill_pages(
        jnp.asarray(q), k, v, jnp.asarray(lengths)))
    btf = tables % fast.shape[0]
    single = K1.paged_attention_prefill(
        torch.from_numpy(q), tf[:, l, 0], tf[:, l, 1],
        torch.from_numpy(btf), torch.from_numpy(lengths))
    dual = K1.paged_attention_prefill_dual(
        *args, torch.from_numpy(btf), torch.zeros_like(torch.from_numpy(sel)),
        torch.from_numpy(lengths))
    assert_same(dual, single)


def test_prefill_cpu_tensors_never_build_or_launch():
    """CPU tensors take the plain versions: no launch is counted under
    any name and the kernel library is never built."""
    from repro_torch.kernels import _build
    kernels.reset_launch_counts()
    fast, q, tables, lengths = _bucket((9, 4), 16, 4, 3, n_slots=8)
    t = torch.from_numpy(fast)
    args = (torch.from_numpy(q), t[:, 0, 0], t[:, 0, 1])
    K1.paged_attention_prefill(*args, torch.from_numpy(tables),
                               torch.from_numpy(lengths))
    K1.paged_attention_prefill_dual(
        *args, t[:, 1, 0], t[:, 1, 1], torch.from_numpy(tables),
        torch.zeros_like(torch.from_numpy(tables)),
        torch.from_numpy(lengths))
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    assert _build._lib is None


ATTN_ARCHS = sorted(a for a, c in registry().items() if c.layout != "mamba")


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_every_config_fits_shared_memory(arch):
    """Every attention config of the port (D 64-256, G 1-8) lies in the
    range the bodies take.  Their shared memory depends on G and D only
    (pages stream in 16-key blocks) and fits at G 8, D 256 by the kernel
    file's static_asserts, so no config or page size K1 took before is
    refused; ``test_launch_plans_fit_every_config_cuda`` reads the
    launch plans on a card."""
    cfg = registry()[arch]
    G, D = cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    assert 1 <= G <= K1.MAX_G and D % 8 == 0 and D <= K1.MAX_D


# =============================================================================
# the card
# =============================================================================

def _on(dev, dtype, *arrays):
    """numpy arrays on the card: floats in ``dtype``, ints as they are."""
    return [torch.from_numpy(a).to(dev, dtype) if a.dtype == np.float32
            else torch.from_numpy(a).to(dev) for a in arrays]


def _scaled(q, Hkv):
    L, Hq, D = q.shape
    return (q * D ** -0.5).reshape(L, Hkv, Hq // Hkv, D)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_prefill_kernel_vs_plain_cuda(dtype, tol, G, D):
    """The prefill body against its plain version over a packed bucket of
    ragged segments (lengths not multiples of the page) that cross the
    64-row tiles; padding rows (length 0) give zeros; one launch, under
    its own name."""
    dev = cuda_device()
    Hkv = 2
    pool, q, tables, lengths = _bucket((70, 3, 100), 200, 16, 8, n_slots=40,
                                       Hq=Hkv * G, Hkv=Hkv, D=D, seed=G + D,
                                       layers=3)
    tpool, tq, tt, tl = _on(dev, dtype, pool, q, tables, lengths)
    qg = _scaled(tq, Hkv).contiguous()
    args = (qg, tpool[:, 2, 0], tpool[:, 2, 1], tt, tl)
    n0 = kernels.launch_counts()["paged_attention_prefill"]
    got = K1.paged_attention_prefill_pooled(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_attention_prefill"] == n0 + 1
    live = lengths > 0
    assert_close(got[live].float(),
                 K1.paged_attention_plain(*args)[live].float(), atol=tol,
                 rtol=tol)
    assert not got[~live].any()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_decode_long_contexts_vs_plain_cuda(dtype, tol, G, D):
    """The decode body over contexts longer than its cluster of 8 CTAs
    has pages and not multiples of the page, plus a row of length 0
    (zeros) and one of a single position."""
    dev = cuda_device()
    Hkv, page, P = 2, 16, 24
    rng = np.random.RandomState(G * D)
    pool = rng.standard_normal((60, 2, 2, page, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((5, Hkv, G, D)).astype(np.float32) * D ** -0.5
    bt = np.stack([rng.permutation(60)[:P] for _ in range(5)]
                  ).astype(np.int32)
    lengths = np.array([P * page, 300, 129, 0, 1], np.int32)
    tpool, tq, tbt, tl = _on(dev, dtype, pool, q, bt, lengths)
    args = (tq, tpool[:, 1, 0], tpool[:, 1, 1], tbt, tl)
    n0 = kernels.launch_counts()["paged_attention"]
    got = K1.paged_attention_pooled(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_attention"] == n0 + 1
    live = lengths > 0
    assert_close(got[live].float(),
                 K1.paged_attention_plain(*args)[live].float(), atol=tol,
                 rtol=tol)
    assert not got[~live].any()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("prefill", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dual_pool_bit_identical_to_single_cuda(prefill, dtype):
    """Both bodies over a pinned second pool give the bits of the single
    pool over the same pages moved into HBM, and count one launch under
    the dual name."""
    dev = cuda_device()
    Hkv, G, D, page = 8, 4, 128, 16
    if prefill:
        fast, q, tables, lengths = _bucket((128, 100), 256, page, 16,
                                           n_slots=24, Hq=Hkv * G, Hkv=Hkv,
                                           D=D, seed=3)
        first = np.where(np.arange(256) < 128, 0, 128)
        sel, bt = _selected(np.random.RandomState(4), tables, 24, 40, first)
    else:
        rng = np.random.RandomState(5)
        fast = rng.standard_normal((24, 2, 2, page, Hkv, D)).astype(
            np.float32)
        q = rng.standard_normal((8, Hkv * G, D)).astype(np.float32)
        tables = np.stack([rng.permutation(24)[:16] for _ in range(8)])
        lengths = rng.randint(129, 257, 8).astype(np.int32)
        sel, bt = _selected(rng, tables, 24, 40)
    pin = np.random.RandomState(6).standard_normal(
        (40,) + fast.shape[1:]).astype(np.float32)
    tf, tq, tbt, tsel, tl = _on(dev, dtype, fast, q, bt, sel, lengths)
    tp = torch.from_numpy(pin).to(dtype).pin_memory()
    name = "paged_attention_prefill_dual" if prefill \
        else "paged_attention_dual"
    fn = K1.paged_attention_prefill_dual if prefill \
        else K1.paged_attention_dual
    single = K1.paged_attention_prefill if prefill else K1.paged_attention
    n0 = kernels.launch_counts()[name]
    got = fn(tq, tf[:, 0, 0], tf[:, 0, 1], tp[:, 0, 0], tp[:, 0, 1], tbt,
             tsel, tl)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == n0 + 1
    merged = torch.cat([tf, tp.to(dev)])
    btm = torch.where(tsel > 0, tbt + tf.shape[0], tbt).to(torch.int32)
    want = single(tq, merged[:, 0, 0], merged[:, 0, 1], btm, tl)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_row_bits_independent_of_place_cuda(dtype):
    """A segment's rows give the same bits alone in a bucket, at another
    offset (across a 64-row tile edge), and packed between other
    segments and padding."""
    dev = cuda_device()
    Hkv, G, D, page, Pp = 8, 4, 128, 16, 8
    rng = np.random.RandomState(7)
    pool = torch.from_numpy(rng.standard_normal(
        (40, 1, 2, page, Hkv, D)).astype(np.float32)).to(dev, dtype)
    seg = 100
    table = rng.permutation(40)[:Pp].astype(np.int32)
    qs = rng.standard_normal((seg, Hkv * G, D)).astype(np.float32)

    def run(off, L, others):
        q = rng.standard_normal((L, Hkv * G, D)).astype(np.float32)
        tables = np.zeros((L, Pp), np.int32)
        lengths = np.zeros(L, np.int32)
        for o, n in others:
            tables[o:o + n] = rng.permutation(40)[:Pp]
            lengths[o:o + n] = np.arange(1, n + 1)
        q[off:off + seg] = qs
        tables[off:off + seg] = table
        lengths[off:off + seg] = np.arange(1, seg + 1)
        tq, tt, tl = _on(dev, dtype, q, tables, lengths)
        out = K1.paged_attention_prefill(tq, pool[:, 0, 0], pool[:, 0, 1],
                                         tt, tl)
        return out[off:off + seg]

    alone = run(0, 128, [])
    for off, L, others in ((37, 256, [(0, 37), (137, 50)]),
                           (150, 256, [(0, 150)]), (3, 128, [(0, 3)])):
        assert torch.equal(run(off, L, others), alone), (off, L)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dual", [False, True])
def test_decode_row_bits_independent_of_batch_cuda(dual):
    """A decode row's bits do not depend on how many rows share the
    launch or where it sits among them."""
    dev = cuda_device()
    Hkv, G, D, page, P, B = 8, 4, 128, 16, 16, 8
    rng = np.random.RandomState(8)
    fast = torch.from_numpy(rng.standard_normal(
        (B * P, 1, 2, page, Hkv, D)).astype(np.float32)).to(
        dev, torch.bfloat16)
    pin = fast.cpu().pin_memory()
    q = torch.from_numpy(rng.standard_normal((B, Hkv * G, D)).astype(
        np.float32)).to(dev, torch.bfloat16)
    bt = torch.from_numpy(rng.permutation(B * P).reshape(B, P).astype(
        np.int32)).to(dev)
    sel = torch.from_numpy((rng.rand(B, P) < 0.5).astype(np.int32)).to(dev)
    lengths = torch.from_numpy(rng.randint(1, P * page + 1, B).astype(
        np.int32)).to(dev)

    def step(rows):
        rows = torch.tensor(rows, device=dev)
        if dual:
            return K1.paged_attention_dual(
                q[rows], fast[:, 0, 0], fast[:, 0, 1], pin[:, 0, 0],
                pin[:, 0, 1], bt[rows].contiguous(), sel[rows].contiguous(),
                lengths[rows].contiguous())
        return K1.paged_attention(q[rows], fast[:, 0, 0], fast[:, 0, 1],
                                  bt[rows].contiguous(),
                                  lengths[rows].contiguous())

    full = step(list(range(B)))
    for r in range(1, B):
        assert torch.equal(step(list(range(r))), full[:r]), r
    assert torch.equal(step(list(range(B))[::-1]), full.flip(0))


@pytest.mark.requires_cuda
def test_wrappers_refuse_what_the_bodies_cannot_take_cuda():
    """D not a multiple of 8, G above 8 and a pool view whose row stride
    is not 16-byte aligned raise before any launch."""
    dev = cuda_device()
    counts = kernels.launch_counts()
    lengths = torch.ones(2, dtype=torch.int32, device=dev)
    bt = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    for G, D in ((1, 12), (9, 16)):
        pool = torch.zeros((2, 4, 1, D), dtype=torch.bfloat16, device=dev)
        q = torch.zeros((2, 1, G, D), dtype=torch.bfloat16, device=dev)
        with pytest.raises(ValueError):
            K1.paged_attention_prefill_pooled(q, pool, pool, bt, lengths)
    wide = torch.zeros((2, 4, 1, 20), dtype=torch.bfloat16, device=dev)
    q = torch.zeros((2, 1, 1, 16), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        K1.paged_attention_pooled(q, wide[..., :16], wide[..., :16], bt,
                                  lengths)
    assert kernels.launch_counts() == counts


@pytest.mark.requires_cuda
@pytest.mark.parametrize("page", [64, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("prefill", [False, True])
def test_large_pages_vs_plain_cuda(prefill, dtype, tol, page):
    """Pages far above 16 (the blocks of 16 keys stream through the
    rings) at the widest shape, G 8 and D 256, on both bodies and both
    pools, against the plain version; lengths end inside a page."""
    dev = cuda_device()
    Hkv, G, D, Pp = 2, 8, 256, 3
    if prefill:
        pool, q, tables, lengths = _bucket((page + 5, 70), 2 * page + 80,
                                           page, Pp, n_slots=12,
                                           Hq=Hkv * G, Hkv=Hkv, D=D,
                                           seed=page, layers=1)
        q = _scaled(torch.from_numpy(q), Hkv).numpy()
    else:
        rng = np.random.RandomState(page)
        pool = rng.standard_normal((12, 1, 2, page, Hkv, D)).astype(
            np.float32)
        q = rng.standard_normal((4, Hkv, G, D)).astype(np.float32) \
            * D ** -0.5
        tables = np.stack([rng.permutation(12)[:Pp] for _ in range(4)]
                          ).astype(np.int32)
        lengths = np.array([Pp * page, 2 * page + 3, page - 1, 1], np.int32)
    tpool, tq, tt, tl = _on(dev, dtype, pool, np.ascontiguousarray(q),
                            tables, lengths)
    args = (tq, tpool[:, 0, 0], tpool[:, 0, 1], tt, tl)
    fn = K1.paged_attention_prefill_pooled if prefill \
        else K1.paged_attention_pooled
    got = fn(*args)
    live = lengths > 0
    assert_close(got[live].float(),
                 K1.paged_attention_plain(*args)[live].float(), atol=tol,
                 rtol=tol)
    tp = tpool.cpu().pin_memory()
    sel = torch.from_numpy(np.broadcast_to(
        np.arange(Pp, dtype=np.int32) % 2, tables.shape).copy()).to(dev)
    dual = K1.paged_attention_prefill_dual_pooled if prefill \
        else K1.paged_attention_dual_pooled
    assert torch.equal(dual(tq, tpool[:, 0, 0], tpool[:, 0, 1], tp[:, 0, 0],
                            tp[:, 0, 1], tt, sel, tl), got)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_launch_plans_fit_every_config_cuda(arch):
    """Every body's launch plan for every attention config fits the
    card's shared memory and keeps at least one CTA resident per SM;
    decode runs as clusters of 8."""
    cuda_device()
    cfg = registry()[arch]
    G, D, Hkv = cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, cfg.n_kv_heads
    for dtype in (torch.float32, torch.bfloat16):
        for prefill in (False, True):
            for dual in (False, True):
                info = K1.launch_info(prefill, dual, dtype, 256, Hkv, G, D)
                assert info["smem_bytes"] <= 227 * 1024, info
                assert info["ctas_per_sm"] >= 1, info
                assert info["cluster"] == (1 if prefill else 8), info



@pytest.mark.requires_cuda
@pytest.mark.parametrize("dual", [False, True])
def test_f32_prefill_graph_replay_and_bits_cuda(dual):
    """The float32 prefill body (3xTF32 on the tensor cores) captured in a
    CUDA graph replays the bits of an eager call, and repeated calls give
    equal bits, on one pool and on two."""
    dev = cuda_device()
    Hkv, G, D, page = 8, 4, 128, 16
    fast, q, tables, lengths = _bucket((128, 100), 256, page, 16,
                                       n_slots=40, Hq=Hkv * G, Hkv=Hkv, D=D,
                                       seed=11)
    tf, tq, tt, tl = _on(dev, torch.float32, fast, q, tables, lengths)
    qg = _scaled(tq, Hkv).contiguous()
    if dual:
        first = np.where(np.arange(256) < 128, 0, 128)
        sel, bt = _selected(np.random.RandomState(12), tables, 40, 40, first)
        tp = tf.cpu().pin_memory()
        args = (qg, tf[:, 0, 0], tf[:, 0, 1], tp[:, 0, 0], tp[:, 0, 1],
                torch.from_numpy(bt).to(dev), torch.from_numpy(sel).to(dev),
                tl)
        fn = K1.paged_attention_prefill_dual_pooled
    else:
        args = (qg, tf[:, 0, 0], tf[:, 0, 1], tt, tl)
        fn = K1.paged_attention_prefill_pooled
    eager = fn(*args)
    assert torch.equal(fn(*args), eager)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("D", [64, 128, 256])
def test_f32_prefill_launch_plan_cuda(D):
    """The float32 prefill plan: 4 warps of one 16-row m-tile, passes of 64
    query rows over the G CTAs of each 64-row tile, shared memory for Q and
    a 3-stage ring of 16 float32 keys at a row stride of D + 4 floats, the
    same plan on two pools."""
    cuda_device()
    Hkv, G, L = 8, 4, 256
    for dual in (False, True):
        info = K1.launch_info(True, dual, torch.float32, L, Hkv, G, D)
        assert info["threads"] == 128, info
        assert info["ctas"] == L // 64 * Hkv * G, info
        assert info["smem_bytes"] == 4 * (D + 4) * (64 + 2 * 3 * 16), info
        assert info["ctas_per_sm"] >= 1 and info["cluster"] == 1, info
