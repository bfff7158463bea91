"""The arithmetic of K1's float32 prefill body and K8's float32 entry on
the tensor cores, on the CPU.

``csrc/paged_attention.cu`` (``paged_prefill_f32_kernel``) and
``csrc/flash_attention.cu`` (``flash_f32_kernel``) run every product of
their float32 attention on ``mma.sync`` in 3xTF32 (``split_tf32`` in
``common.cuh``): each float32 operand x is split into a big TF32 term,
x rounded to nearest (ties away from zero) at 10 mantissa bits
(``tf32``), and a small one, x - big, of which the tensor cores read the
top 11 significant bits (they truncate a TF32 operand's low 13 bits,
``trunc_tf32``); a product a.b is small_a.big_b + big_a.small_b +
big_a.big_b summed in float32.  The products of two TF32 terms are exact
in float32, so float32 matmuls of the terms emulate the tensor cores up to
the order and rounding of the float32 sums.  ``k1_prefill`` and ``k8`` below replay the
two bodies' blockwise online softmax with that arithmetic (test helpers, on
no path): K1 over a packed bucket's pages in blocks of 16 keys, a block
never spanning two pages, with a row's keys past its length masked out of
the maximum and given probability 0; K8 in 128-row query blocks and
64-key tiles from the window's edge to the causal edge and ``seq_len``.
``k8_wide`` replays K8's float32 kernel for 128 < D <= 256
(``flash_f32_d256_kernel``, on ``wgmma``): D padded to 256, 64-row query
blocks, 32-key tiles, and S made by two warpgroups, one per half of D,
each from three accumulators (big.big, big.small, small.big), summed as
(big.small + small.big) + big.big; the two halves' partials are added in
one order, and each tile's P . V starts from zero before O * alpha + P . V.

They are held within 1e-5 (``PAGED_F32_TOL`` and ``FLASH_F32_TOL``, the
limits the kernels keep against their plain versions on the card) of the
JAX package's Pallas kernels in interpret mode (the decode kernel at one
row per packed position, as the JAX prefill op runs it, and
``flash_attention_bhsd`` through ``ops.flash_attention``) and of a float64
reference.  The control: the cheaper splits, one TF32 term (what a TF32
matmul does) or big.big + big.small, miss 1e-5, so the tests can fail.
bf16 terms hold with three terms per operand and six products
(``bf16x6``): the same count of tensor-core instructions as 3xTF32
(m16n8k16 against m16n8k8) with a costlier split; with two terms and
three products they sit near the limit (0.8-1.4 of it), so they are no
choice.
"""
import numpy as np
import pytest
import torch

from helpers.torch_parity import cap_threads

cap_threads()

TOL = 1e-5                 # PAGED_F32_TOL, FLASH_F32_TOL
NEG_INF = -1e30
KEY_BLOCK = 16             # K1: keys per block
FLASH_BQ, FLASH_BK = 128, 64     # K8 float32: query rows per CTA, keys per tile
WIDE_BQ, WIDE_BK, WIDE_D = 64, 32, 256   # past D 128: rows, keys, padded D
SCHEMES = ("3xtf32", "bf16x6")   # splits that hold 1e-5
CHEAPER = ("1xtf32", "2xtf32")   # splits that miss it


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as the kernels round the big term: add half a
    TF32 ulp to the float32 bits and clear the low 13 (round to nearest,
    ties away from zero)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor cores read a TF32 operand: its low 13 bits
    ignored."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two TF32 terms of ``split_tf32``: big = tf32(x) and the small
    term as the cores read x - big."""
    big = tf32(x)
    return big, trunc_tf32(x - big)


def _bf16_terms(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    out = []
    for _ in range(n):
        hi = x.to(torch.bfloat16).float()
        out.append(hi)
        x = x - hi
    return out


def product(a: torch.Tensor, b: torch.Tensor, scheme: str) -> torch.Tensor:
    """a @ b as the tensor cores compute it from the terms of ``scheme``:
    exact products of the terms, float32 sums."""
    if scheme in ("3xtf32", "2xtf32"):
        (ab, as_), (bb, bs) = split(a), split(b)
        big = ab @ bs + ab @ bb
        return big if scheme == "2xtf32" else as_ @ bb + big
    if scheme == "1xtf32":
        return tf32(a) @ tf32(b)
    if scheme == "bf16x6":
        h, m, lo = _bf16_terms(a, 3)
        H, M, Lo = _bf16_terms(b, 3)
        return h @ Lo + lo @ H + m @ M + h @ M + m @ H + h @ H
    if scheme == "bf16x3":
        h, lo = _bf16_terms(a, 2)
        H, Lo = _bf16_terms(b, 2)
        return h @ Lo + lo @ H + h @ H
    raise ValueError(scheme)


def _online_block(m, l, o, s, ok, v, scheme):
    """One block of the online softmax: s [.., n, keys] scores, ok their
    mask (masked keys leave the maximum alone and get probability 0), v
    [.., keys, D]."""
    s = torch.where(ok, s, torch.tensor(NEG_INF))
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.where(ok, torch.exp(s - m_new), torch.tensor(0.0))
    return (m_new, l * alpha + p.sum(-1, keepdim=True),
            o * alpha + product(p, v, scheme))


def k1_prefill(q, k_pool, v_pool, tables, lengths, scheme="3xtf32"):
    """K1's float32 prefill body: q pre-scaled [L, Hkv, G, D]; pools
    [slots, page, Hkv, D]; per-row tables [L, Pp]; lengths [L].  Rows that
    share a table (a packed segment) stream its pages together up to
    their largest length, in blocks of 16 keys within each page; a block
    past a row's length changes nothing for it."""
    L, Hkv, G, D = q.shape
    page = k_pool.shape[1]
    out = torch.zeros_like(q)
    _, seg = np.unique(tables.numpy(), axis=0, return_inverse=True)
    for s in np.unique(seg):
        rows = torch.from_numpy(np.flatnonzero(seg == s))
        table, lens = tables[rows[0]], lengths[rows].long()
        plen = int(lens.max())
        n_pages = min(-(-plen // page), table.numel())
        qr = q[rows].permute(1, 0, 2, 3).reshape(Hkv, -1, D)   # [Hkv, n*G, D]
        lim_row = lens.repeat_interleave(G)[None, :, None]      # [1, n*G, 1]
        m = torch.full((Hkv, qr.shape[1], 1), NEG_INF)
        l = torch.zeros_like(m)
        o = torch.zeros_like(qr)
        for ip in range(n_pages):
            slot = int(table[ip])
            for kb in range(0, min(page, plen - ip * page), KEY_BLOCK):
                keys = slice(kb, min(kb + KEY_BLOCK, page, plen - ip * page))
                kt = k_pool[slot, keys].permute(1, 2, 0)         # [Hkv, D, n]
                vt = v_pool[slot, keys].permute(1, 0, 2)         # [Hkv, n, D]
                pos = ip * page + torch.arange(keys.start, keys.stop)
                m, l, o = _online_block(m, l, o, product(qr, kt, scheme),
                                        pos[None, None, :] < lim_row, vt,
                                        scheme)
        res = o / torch.clamp(l, min=1e-30)
        out[rows] = res.reshape(Hkv, -1, G, D).permute(1, 0, 2, 3)
    return out


def k8(q, k, v, *, causal=True, window=0, seq_len=None, scheme="3xtf32"):
    """K8's float32 entry: q [B, Sq, Hq, D] scaled by D**-0.5 in float32,
    k/v [B, Sk, Hkv, D]; 128-row query blocks over 64-key tiles from the
    window's edge to the causal edge and seq_len."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    seq_len = Sk if seq_len is None else seq_len
    qh = (q * D ** -0.5).permute(0, 2, 1, 3)
    kh = k.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, 1)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, 1)
    out = torch.zeros_like(qh)
    for q0 in range(0, Sq, FLASH_BQ):
        qb = qh[:, :, q0:q0 + FLASH_BQ]
        qpos = torch.arange(q0, q0 + qb.shape[2])[:, None]
        hi = min(seq_len, Sk)
        if causal:
            hi = min(hi, Sq, q0 + FLASH_BQ)
        lo = max(0, q0 - window + 1) // FLASH_BK * FLASH_BK if window else 0
        m = torch.full(qb.shape[:3] + (1,), NEG_INF)
        l = torch.zeros_like(m)
        o = torch.zeros_like(qb)
        for kb in range(lo, hi, FLASH_BK):
            kt = kh[:, :, kb:kb + FLASH_BK]
            key = torch.arange(kb, kb + kt.shape[2])[None, :]
            ok = key < seq_len
            if causal:
                ok = ok & (key <= qpos)
            if window:
                ok = ok & (qpos - key < window)
            m, l, o = _online_block(m, l, o,
                                    product(qb, kt.transpose(-1, -2), scheme),
                                    ok, vh[:, :, kb:kb + FLASH_BK], scheme)
        out[:, :, q0:q0 + qb.shape[2]] = o / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3)


def _wide_half_s(qh, kh, scheme):
    """One warpgroup's partial S over its half of D: [.., rows, keys]."""
    kt = kh.transpose(-1, -2)
    if scheme == "1xtf32":
        return tf32(qh) @ tf32(kt)
    (qb, qs), (kb, ks) = split(qh), split(kt)
    return (qb @ ks + qs @ kb) + qb @ kb


def k8_wide(q, k, v, *, causal=True, window=0, seq_len=None,
            scheme="3xtf32"):
    """K8's float32 kernel past D 128: q [B, Sq, Hq, D] scaled by D**-0.5
    in float32, k/v [B, Sk, Hkv, D]; D padded with zeros to 256; 64-row
    query blocks over 32-key tiles from the window's edge to the causal
    edge and seq_len; S the sum of the two halves' partials; P . V per tile
    from zero (``product``)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    seq_len = Sk if seq_len is None else seq_len
    pad = (0, WIDE_D - D)
    qh = torch.nn.functional.pad((q * D ** -0.5).permute(0, 2, 1, 3), pad)
    kh = torch.nn.functional.pad(
        k.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, 1), pad)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, 1)
    half = WIDE_D // 2
    out = torch.zeros(B, Hq, Sq, D)
    for q0 in range(0, Sq, WIDE_BQ):
        qb = qh[:, :, q0:q0 + WIDE_BQ]
        qpos = torch.arange(q0, q0 + qb.shape[2])[:, None]
        hi = min(seq_len, Sk)
        if causal:
            hi = min(hi, Sq, q0 + WIDE_BQ)
        lo = max(0, q0 - window + 1) // WIDE_BK * WIDE_BK if window else 0
        m = torch.full(qb.shape[:3] + (1,), NEG_INF)
        l = torch.zeros_like(m)
        o = torch.zeros(qb.shape[:3] + (D,))
        for kb in range(lo, hi, WIDE_BK):
            kt = kh[:, :, kb:kb + WIDE_BK]
            s = (_wide_half_s(qb[..., :half], kt[..., :half], scheme)
                 + _wide_half_s(qb[..., half:], kt[..., half:], scheme))
            key = torch.arange(kb, kb + kt.shape[2])[None, :]
            ok = key < seq_len
            if causal:
                ok = ok & (key <= qpos)
            if window:
                ok = ok & (qpos - key < window)
            m, l, o = _online_block(m, l, o, s, ok,
                                    vh[:, :, kb:kb + WIDE_BK], scheme)
        out[:, :, q0:q0 + qb.shape[2]] = o / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3)


# =============================================================================
# references
# =============================================================================

def _attention64(s, ok, v):
    """softmax(s masked by ok) @ v in float64 (masked keys count 0)."""
    s = np.where(ok, s, -np.inf)
    w = np.exp(s - s.max(-1, keepdims=True))
    return (w / w.sum(-1, keepdims=True)) @ v


def _k1_ref64(q, k_pool, v_pool, tables, lengths):
    q, kp, vp = (a.double().numpy() for a in (q, k_pool, v_pool))
    L, Hkv, G, D = q.shape
    out = np.zeros_like(q)
    for r in range(L):
        n = int(lengths[r])
        if n == 0:
            continue
        kk = kp[tables[r].numpy()].reshape(-1, Hkv, D)[:n]     # [n, Hkv, D]
        vv = vp[tables[r].numpy()].reshape(-1, Hkv, D)[:n]
        s = np.einsum("hgd,khd->hgk", q[r], kk)               # [Hkv, G, n]
        out[r] = np.stack([_attention64(s[h], np.ones_like(s[h], bool),
                                        vv[:, h]) for h in range(Hkv)])
    return out


def _k8_ref64(q, k, v, causal, window, seq_len):
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qh = q.double().numpy().transpose(0, 2, 1, 3) * D ** -0.5
    kh = np.repeat(k.double().numpy().transpose(0, 2, 1, 3), Hq // Hkv, 1)
    vh = np.repeat(v.double().numpy().transpose(0, 2, 1, 3), Hq // Hkv, 1)
    qp, kp = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    ok = kp < seq_len
    if causal:
        ok = ok & (kp <= qp)
    if window:
        ok = ok & (qp - kp < window)
    return _attention64(qh @ kh.transpose(0, 1, 3, 2), ok, vh
                        ).transpose(0, 2, 1, 3)


def _excess(got, want) -> float:
    """The largest |got - want| as a share of the limit atol = rtol = TOL:
    below 1 within it."""
    got = np.asarray(got, np.float64)
    return float((np.abs(got - want) / (TOL * (1 + np.abs(want)))).max())


# K1: a packed bucket of ragged segments (lengths not multiples of the
# page or of 16, one crossing the 64-row tile edge) and padding rows;
# pages of 16 (one block), 24 (a block of 16 and one of 8) and 8
BUCKETS = {"page16": ((37, 20), 64, 16, 4), "page24": ((50, 11), 64, 24, 3),
           "page8": ((29, 19), 56, 8, 5)}


def _k1_inputs(segs, L, page, Pp, G, seed, Hkv=2, D=64, n_slots=24):
    rng = np.random.RandomState(seed)
    k_pool = rng.standard_normal((n_slots, page, Hkv, D)).astype(np.float32)
    v_pool = rng.standard_normal((n_slots, page, Hkv, D)).astype(np.float32)
    q = (rng.standard_normal((L, Hkv, G, D)) * D ** -0.5).astype(np.float32)
    tables = np.zeros((L, Pp), np.int32)
    lengths = np.zeros(L, np.int32)
    off = 0
    for n in segs:
        tables[off:off + n] = rng.permutation(n_slots)[:Pp]
        lengths[off:off + n] = np.arange(1, n + 1)
        off += n
    return [torch.from_numpy(a) for a in (q, k_pool, v_pool, tables,
                                          lengths)]


def _k1_pallas(q, k_pool, v_pool, tables, lengths):
    """The JAX prefill op's arithmetic through the Pallas decode kernel in
    interpret mode: one row per packed position, its own table."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.paged_attention.paged_attention import (
        paged_attention_pooled)
    return np.asarray(paged_attention_pooled(
        *(jnp.asarray(a.numpy()) for a in (q, k_pool, v_pool, tables,
                                            lengths)), interpret=True),
        np.float64)


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(BUCKETS))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_k1_prefill_split_holds(scheme, case, G):
    """The float32 prefill body's arithmetic over a packed bucket within
    1e-5 of the Pallas kernel in interpret mode and of float64; padding
    rows give zeros."""
    segs, L, page, Pp = BUCKETS[case]
    args = _k1_inputs(segs, L, page, Pp, G, seed=G + page)
    got = k1_prefill(*args, scheme=scheme)
    live = args[4].numpy() > 0
    assert not got[~live].any()
    want = _k1_ref64(*args)
    assert _excess(got[live], want[live]) < 1, "float64"
    assert _excess(got[live], _k1_pallas(*args)[live]) < 1, "pallas"


# K8: (B, S, Hq, Hkv, D, causal, window, seq_len): causal across 128-row
# query blocks and 64-key tiles, a window, GQA, seq_len, non-causal
FLASH = {"causal": (1, 200, 4, 4, 64, True, 0, None),
         "window": (2, 160, 4, 2, 64, True, 48, None),
         "gqa_seq_len": (1, 150, 8, 2, 80, True, 0, 130),
         "noncausal": (1, 96, 2, 2, 112, False, 0, None)}


def _k8_inputs(B, S, Hq, Hkv, D, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal((B, S, h, D)).astype(
        np.float32)) for h in (Hq, Hkv, Hkv)]


def _k8_pallas(q, k, v, causal, window, seq_len):
    """The Pallas kernel in interpret mode, through the JAX op (which
    scales q and pads S and D); keys past seq_len by a k/v cut to it."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ops import flash_attention
    if seq_len is not None:
        k, v = k[:, :seq_len], v[:, :seq_len]
    return np.asarray(flash_attention(
        *(jnp.asarray(a.numpy()) for a in (q, k, v)), causal=causal,
        window=window, interpret=True), np.float64)


@pytest.mark.parametrize("case", sorted(FLASH))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_k8_split_holds(scheme, case):
    """The float32 entry's arithmetic within 1e-5 of float64 and of the
    Pallas kernel in interpret mode: causal, window, GQA and seq_len."""
    B, S, Hq, Hkv, D, causal, window, seq_len = FLASH[case]
    q, k, v = _k8_inputs(B, S, Hq, Hkv, D, seed=S + D)
    got = k8(q, k, v, causal=causal, window=window, seq_len=seq_len,
             scheme=scheme)
    want = _k8_ref64(q, k, v, causal, window, S if seq_len is None
                     else seq_len)
    assert _excess(got, want) < 1, "float64"
    assert _excess(got, _k8_pallas(q, k, v, causal, window, seq_len)) < 1, \
        "pallas"


# K8 past D 128: (B, S, Hq, Hkv, D, causal, window, seq_len) at smoke size:
# causal across 64-row blocks and 32-key tiles, a window, GQA with
# seq_len at D 136 (a D padded to 256), non-causal
WIDE = {"causal": (1, 128, 2, 1, 256, True, 0, None),
        "window": (1, 100, 2, 2, 256, True, 24, None),
        "gqa_seq_len_d136": (1, 96, 4, 1, 136, True, 0, 70),
        "noncausal": (1, 72, 2, 2, 256, False, 0, None)}


@pytest.mark.parametrize("case", sorted(WIDE))
def test_k8_wide_split_holds(case):
    """The arithmetic of the float32 kernel past D 128 within 1e-5 of
    float64 and of the Pallas kernel in interpret mode (through the JAX
    op); one TF32 term per operand misses 1e-5 against float64, so the
    test can fail."""
    B, S, Hq, Hkv, D, causal, window, seq_len = WIDE[case]
    q, k, v = _k8_inputs(B, S, Hq, Hkv, D, seed=S + D + 1)
    kw = dict(causal=causal, window=window, seq_len=seq_len)
    got = k8_wide(q, k, v, **kw)
    want = _k8_ref64(q, k, v, causal, window, S if seq_len is None
                     else seq_len)
    assert _excess(got, want) < 1, "float64"
    assert _excess(got, _k8_pallas(q, k, v, causal, window, seq_len)) < 1, \
        "pallas"
    assert _excess(k8_wide(q, k, v, scheme="1xtf32", **kw), want) > 1, \
        "one TF32 term"


@pytest.mark.parametrize("scheme", CHEAPER)
def test_cheaper_splits_miss(scheme):
    """The control: each cheaper split misses 1e-5 against float64 in
    both bodies at shapes where 3xTF32 holds, so the tests above can
    fail."""
    segs, L, page, Pp = BUCKETS["page16"]
    args = _k1_inputs(segs, L, page, Pp, 4, seed=20)
    live = args[4].numpy() > 0
    want = _k1_ref64(*args)[live]
    assert _excess(k1_prefill(*args)[live], want) < 1
    assert _excess(k1_prefill(*args, scheme=scheme)[live], want) > 1
    B, S, Hq, Hkv, D, causal, window, seq_len = FLASH["causal"]
    q, k, v = _k8_inputs(B, S, Hq, Hkv, D, seed=21)
    want = _k8_ref64(q, k, v, causal, window, S)
    assert _excess(k8(q, k, v), want) < 1
    assert _excess(k8(q, k, v, scheme=scheme), want) > 1


def test_tf32_terms():
    """``tf32`` keeps 10 mantissa bits and rounds half an ulp away from
    zero, ``trunc_tf32`` clears the low 13 bits; the two terms of a split
    hold x to 2**-21 of |x|."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 4, -(1 + ulp / 2), 1 + 3 * ulp
                      / 4, 3.0])
    assert tf32(x).tolist() == [1 + ulp, 1.0, -(1 + ulp), 1 + ulp, 3.0]
    assert trunc_tf32(x).tolist() == [1.0, 1.0, -1.0, 1.0, 3.0]
    y = torch.from_numpy(np.random.RandomState(0).standard_normal(1000)
                         .astype(np.float32))
    big, small = split(y)
    assert not (big.view(torch.int32) & 0x1fff).any()
    assert not (small.view(torch.int32) & 0x1fff).any()
    rel = ((big.double() + small.double() - y.double()).abs()
           / y.double().abs()).max()
    assert rel <= 2.0 ** -21
