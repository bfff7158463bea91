"""The arithmetic and the launch plan of bf16 K8 past D 128
(``flash_d256_kernel`` in ``csrc/flash_attention.cu``).

``_emulate`` repeats the kernel's arithmetic on the CPU in float32: work
items of 128 q rows, two warpgroups of 64 rows each with its own run of
128-key tiles inside the item's key range, S kept unscaled and keys
masked to -2**100 at the ``seq_len``, causal and window edges, the
probabilities as exp2(fmaf(s, scale, -m * scale)) (the scale folded into
the exponent, log2 domain), the online softmax's rescale factor applied
to O before each tile's P.V, P rounded to bf16 per tile (the row sums
take P before the rounding), and O / max(l, 1e-30) rounded to bf16.  At
D 256 and 136, G 1, 2 and 3, causal, windowed, non-causal and with
``seq_len`` < S, it is held against the plain version and against the
Pallas kernel ``flash_attention_bhsd`` in interpret mode within K8's
bf16 tolerance, 1e-2; one case drops the rescale and must miss.

``_schedule`` mirrors the kernel's persistent grid: at most one CTA an
SM, the work items (q block, b * Hq + h) heaviest causal q block first,
dealt to the CTAs in a snake.  Its tests check that every item is one
CTA's once and that the causal schedule is within 5 % of an even split;
on a card (``requires_cuda``, skipped here) the kernel's own plan
(``wide_launch_info``) is held against the mirror.
"""
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_close, cap_threads, cuda_device
from repro_torch.kernels import flash_attention as K8

cap_threads()

BQ, WG_ROWS, BK = 128, 64, 128     # q rows an item, a warpgroup; keys a tile
MASKED = -2.0 ** 100               # exact under the scale (the fold)
TOL = 1e-2
THREADS = 384                      # two consumer warpgroups + a producer
# Q, one K and one V tile of four 64-column boxes, and 6 mbarriers
SMEM = 1024 + 4 * BQ * 128 + 2 * 4 * BK * 128 + 8 * (2 + 2 * (1 + 1))
SMS = 132                          # the H100's SMs


def _key_range(qw, Sq, Sk, seq_len, causal, window):
    """Keys [lo, hi) that q rows [qw, qw + 64) can see, lo a whole tile."""
    hi = min(seq_len, Sk)
    if causal:
        hi = min(hi, min(Sq, qw + WG_ROWS))
    lo = max(0, qw - window + 1) // BK * BK if window > 0 else 0
    if qw >= Sq:
        hi = lo
    return lo, hi


def _cta_tiles(q0, Sq, Sk, seq_len, causal, window):
    """An item's first key and tile count, and each warpgroup's tiles
    [ib, ie) among them."""
    (lo0, hi0), (lo1, hi1) = (_key_range(q0 + WG_ROWS * w, Sq, Sk, seq_len,
                                         causal, window) for w in (0, 1))
    lo, hi = lo0, max(hi0, hi1)
    n = -(-(hi - lo) // BK) if hi > lo else 0
    runs = []
    for my_lo, my_hi in ((lo0, hi0), (lo1, hi1)):
        ib = min((my_lo - lo) // BK, n)
        ie = max(ib, min(n, -(-(my_hi - lo) // BK))) if my_hi > my_lo else ib
        runs.append((ib, ie))
    return lo, n, runs


def _emulate(q, k, v, *, causal=True, window=0, seq_len=None, scale=None,
             rescale=True):
    """The kernel's arithmetic in float32 on bf16 q, k, v [B, S, H, D]."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    seq_len = Sk if seq_len is None else seq_len
    scale_log2 = np.float32((D ** -0.5 if scale is None else scale)
                            * np.float32(1.4426950408889634))
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros((B, Sq, Hq, D), dtype=torch.float32)
    for b in range(B):
        for h in range(Hq):
            for q0 in range(0, Sq, BQ):
                lo, _, runs = _cta_tiles(q0, Sq, Sk, seq_len, causal,
                                         window)
                for w, (ib, ie) in enumerate(runs):
                    qw = q0 + WG_ROWS * w
                    rows = torch.arange(qw, qw + WG_ROWS)
                    qt = torch.zeros((WG_ROWS, D))
                    live = rows < Sq
                    qt[live] = qf[b, rows[live], h]
                    o = torch.zeros((WG_ROWS, D))
                    m = torch.full((WG_ROWS,), MASKED)
                    l = torch.zeros(WG_ROWS)
                    for i in range(ib, ie):
                        keys = torch.arange(lo + i * BK, lo + (i + 1) * BK)
                        kt = torch.zeros((BK, D))
                        vt = torch.zeros((BK, D))
                        inside = keys < Sk            # TMA's zero fill
                        kt[inside] = kf[b, keys[inside], h // G]
                        vt[inside] = vf[b, keys[inside], h // G]
                        x = qt @ kt.T                 # unscaled
                        ok = (keys < seq_len)[None, :].expand(WG_ROWS, BK)
                        if causal:
                            ok = ok & (keys[None, :] <= rows[:, None])
                        if window > 0:
                            ok = ok & (rows[:, None] - keys[None, :] < window)
                        x = torch.where(ok, x, torch.tensor(MASKED))
                        mn = torch.maximum(m, x.max(dim=1).values)
                        alpha = torch.exp2((m - mn) * scale_log2)
                        ms = mn * scale_log2
                        m = mn
                        # fmaf(x, scale, -ms): one rounding to float32
                        p = torch.exp2((x.double() * float(scale_log2)
                                        - ms.double()[:, None]).float())
                        l = l * alpha + p.sum(dim=1)
                        if rescale:
                            o = o * alpha[:, None]
                        o = o + p.to(torch.bfloat16).float() @ vt
                    res = o / torch.clamp(l, min=1e-30)[:, None]
                    out[b, rows[live], h] = res[live]
    return out.to(torch.bfloat16)


def _pallas(q, k, v, causal, window, seq_len):
    """``flash_attention_bhsd`` in interpret mode on float32 copies of q,
    k, v: q pre-scaled, S padded to the 64-row blocks and D to 128 with
    zeros, keys at and past ``seq_len`` masked."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention.flash_attention import (
        flash_attention_bhsd)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    Sp, Dp = -(-S // 64) * 64, -(-D // 128) * 128

    def flat(t, h, s):
        a = t.float().numpy().transpose(0, 2, 1, 3).reshape(B * h, S, D) * s
        return jnp.asarray(np.pad(a, ((0, 0), (0, Sp - S), (0, Dp - D))))
    out = flash_attention_bhsd(
        flat(q, Hq, D ** -0.5), flat(k, Hkv, 1.0), flat(v, Hkv, 1.0),
        causal=causal, window=window, bq=64, bk=64,
        seq_len=S if seq_len is None else seq_len, interpret=True)
    return np.asarray(out)[:, :S, :D].reshape(B, Hq, S, D) \
        .transpose(0, 2, 1, 3)


def _qkv(B, S, Hq, Hkv, D, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal((B, S, h, D))
                             .astype(np.float32)).to(torch.bfloat16)
            for h in (Hq, Hkv, Hkv)]


CASES = [
    # B, S, Hq, Hkv, causal, window, seq_len
    (1, 300, 4, 2, True, 0, None),        # G 2, causal, two items
    (1, 170, 2, 2, True, 0, 150),         # G 1, seq_len < S, ragged S
    (1, 300, 4, 2, True, 70, None),       # G 2, a window that cuts tiles
    (1, 260, 6, 2, False, 40, 230),       # G 3, non-causal window, seq_len
    (2, 140, 2, 1, False, 0, 100),        # G 2, non-causal, seq_len
]


@pytest.mark.parametrize("D", [256, 136])
@pytest.mark.parametrize("B,S,Hq,Hkv,causal,window,seq_len", CASES)
def test_emulation_vs_plain_and_pallas(D, B, S, Hq, Hkv, causal, window,
                                       seq_len):
    pytest.importorskip("jax")
    q, k, v = _qkv(B, S, Hq, Hkv, D, seed=D + S + Hq)
    got = _emulate(q, k, v, causal=causal, window=window, seq_len=seq_len)
    plain = K8.flash_attention(q, k, v, causal=causal, window=window,
                               seq_len=seq_len)
    assert got.shape == plain.shape == (B, S, Hq, D)
    assert_close(got.float(), plain.float(), atol=TOL, rtol=TOL)
    assert_close(got.float(), _pallas(q, k, v, causal, window, seq_len),
                 atol=TOL, rtol=TOL)


@pytest.mark.parametrize("window", [0, 70])
def test_emulation_without_rescale_misses(window):
    """The control: O not rescaled by the new maximum before a tile's
    P.V puts the rows that cross several tiles far off."""
    q, k, v = _qkv(1, 300, 4, 2, 256, seed=9)
    got = _emulate(q, k, v, window=window, rescale=False)
    plain = K8.flash_attention(q, k, v, window=window)
    assert float((got.float() - plain.float()).abs().max()) > 10 * TOL


# ---------------------------------------------------------------- the plan

def _tiles_of(q0, Sq, window):
    """An item's tile count, causal, seq_len = Sq."""
    return _cta_tiles(q0, Sq, Sq, Sq, True, window)[1]


def _schedule(B, Sq, Hq, ctas=SMS):
    """The kernel's persistent grid: CTAs, and per CTA its items (b, h,
    first q row) in order.  Item k is q block (heaviest first) k // (B *
    Hq), head k % (B * Hq); CTA c takes, in round r, item r * n + c (r
    even) or r * n + n - 1 - c (r odd), n the CTAs."""
    heads = B * Hq
    nqb = -(-Sq // BQ)
    n_items = nqb * heads
    n = min(ctas, n_items)
    plan = []
    for c in range(n):
        mine, r = [], 0
        while True:
            k = r * n + (n - 1 - c if r % 2 else c)
            if k >= n_items:
                break
            y, x = divmod(k, heads)
            mine.append((x // Hq, x % Hq, (nqb - 1 - y) * BQ))
            r += 1
        plan.append(mine)
    return n, plan


@pytest.mark.parametrize("B,Sq,Hq,ctas", [(4, 2000, 8, SMS), (2, 333, 6, SMS),
                                          (1, 100, 4, SMS), (3, 517, 12, 7),
                                          (4, 2000, 8, 1), (1, 64, 2, 2),
                                          (2, 1100, 16, SMS),
                                          (2, 1100, 24, SMS)])
def test_schedule_covers_each_item_once(B, Sq, Hq, ctas):
    n, plan = _schedule(B, Sq, Hq, ctas)
    assert n == min(ctas, B * Hq * -(-Sq // BQ))
    seen = sorted(it for mine in plan for it in mine)
    assert seen == sorted((b, h, q0) for b in range(B) for h in range(Hq)
                          for q0 in range(0, Sq, BQ))
    # each CTA's first item is no lighter than its later ones (causal)
    for mine in plan:
        assert all(a[2] >= c[2] for a, c in zip(mine, mine[1:]))


@pytest.mark.parametrize("window", [0, 1024])
def test_schedule_evens_out_the_causal_work(window):
    """At gemma3's shape the snake's heaviest CTA carries within 5 % of
    an even split of the tiles (one tile's worth added an item for its Q
    load and epilogue); dealing the items round-robin is the control,
    16 % over on the causal schedule."""
    B, Sq, Hq = 4, 2000, 8
    n, plan = _schedule(B, Sq, Hq)
    cost = [sum(_tiles_of(q0, Sq, window) + 1 for _, _, q0 in mine)
            for mine in plan]
    even = sum(cost) / n
    assert max(cost) <= 1.05 * even
    heads = B * Hq
    nqb = -(-Sq // BQ)
    rr = [0] * n
    for k in range(nqb * heads):
        rr[k % n] += _tiles_of((nqb - 1 - k // heads) * BQ, Sq, window) + 1
    if window == 0:
        assert max(rr) > 1.15 * even


def test_warpgroup_runs_inside_the_item_range():
    """Each warpgroup's tiles [ib, ie) lie inside the item's run and hold
    every key its rows can see; the tiles outside it are waited for and
    released without math."""
    for Sq, window, seq_len, causal in ((2000, 0, 2000, True),
                                        (2000, 1024, 2000, True),
                                        (517, 70, 400, True),
                                        (260, 40, 230, False)):
        for q0 in range(0, Sq, BQ):
            lo, n, runs = _cta_tiles(q0, Sq, Sq, seq_len, causal, window)
            for w, (ib, ie) in enumerate(runs):
                assert 0 <= ib <= ie <= n
                qw = q0 + WG_ROWS * w
                for r in range(qw, min(qw + WG_ROWS, Sq)):
                    first = max(0, r - window + 1) if window else 0
                    last = min(seq_len, r + 1 if causal else Sq)
                    if last > first:
                        assert lo + ib * BK <= first
                        assert last <= lo + ie * BK


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,Sq,Hq", [(4, 2000, 8), (1, 333, 6), (2, 97, 4)])
def test_wide_launch_plan_cuda(B, Sq, Hq):
    """The kernel's own plan equals the mirror's: one CTA an SM (at most
    one an item), 384 threads, Q and one K and one V tile of 64 KB each,
    one CTA resident an SM, launch registers within the 168 that 384
    threads leave (``setmaxnreg`` then moves them to the consumers)."""
    cuda_device()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n, _ = _schedule(B, Sq, Hq, sms)
    info = K8.wide_launch_info(B, Sq, Hq)
    assert info["ctas"] == n, info
    assert info["threads"] == THREADS, info
    assert info["smem_bytes"] == SMEM, info
    assert info["ctas_per_sm"] == 1, info
    assert info["registers"] <= 168, info
