"""``qkv_rope_append``: one layer's qk-norm, RoPE, q scaling and KV append.

The serving path calls ``models.attention.rope_append``: CUDA tensors
launch the kernel, CPU tensors run its plain version
``rope_append_plain``.  On the CPU that plain version is held against
the JAX package: ``project_qkv`` (norm and
RoPE after the projections), the q scaling of ``paged_attention``'s ops
and the drop-mode ``.at[].set`` scatters of the engine, on the same
numpy inputs.  The projections are made exact (each weight column picks
one input column), so the comparison starts from equal raw q/k/v.
Tolerances: float32 ``atol=1e-5, rtol=1e-4`` (the two frameworks sum the
norm's squares in other orders); bfloat16 one ulp of bfloat16 at the
value's magnitude, the pools and q alike.  Integer placement (which
slot, offset and pool each row lands in, what is dropped) is exact.

The ``requires_cuda`` cases hold the kernel against the plain version on
the card (every bit with the norm off; with it on one ulp in bf16 and
atol = rtol = 1e-6 in float32, see ``test_kernel_vs_plain_cuda``), a
row's bits
alone against its bits in a batch of 8 and in a 256-row bucket, and a
CUDA-graph replay against the eager call; they skip here.
"""
import numpy as np
import pytest
import torch

from helpers.torch_parity import (assert_close, assert_same, cap_threads,
                                  cuda_device, np_of)
from repro_torch import kernels
from repro_torch.kernels import kv_append as KA
from repro_torch.models import attention, layers

cap_threads()

PAGE, LAYERS = 4, 2


def _ulp(x: np.ndarray, dtype) -> np.ndarray:
    """One ulp of ``dtype`` at |x| (float32 math on float64 values)."""
    mant = 7 if dtype == torch.bfloat16 else 23
    a = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - mant)


def assert_within_ulp(got, want, dtype) -> None:
    g, w = (np_of(a.float() if isinstance(a, torch.Tensor) else a)
            .astype(np.float64) for a in (got, want))
    ulp = _ulp(np.maximum(np.abs(g), np.abs(w)), dtype)
    bad = np.abs(g - w) > ulp
    assert not bad.any(), (f"{int(bad.sum())} of {bad.size} values more "
                           f"than one ulp apart; worst "
                           f"{np.abs(g - w)[bad].max()}")


def _inputs(seed, R, Hq, Hkv, D, norm, two_pools):
    """Raw q [R, Hq, D] and k/v [R, Hkv, D], norm weights, float32 RoPE
    tables [R, D/2] at positions up to 4095, both pools and per-row slots:
    every row at its own (slot, offset), half of them (with two pools)
    in the second pool at the same slot number (a numeric collision
    across the pools), the last row dropped in both (padding)."""
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((R, Hq, D)).astype(np.float32) * 2
    k = rng.standard_normal((R, Hkv, D)).astype(np.float32) * 2
    v = rng.standard_normal((R, Hkv, D)).astype(np.float32)
    w = {}
    if norm:
        w["q_norm"] = (1 + rng.standard_normal(D) / 4).astype(np.float32)
        w["k_norm"] = (1 + rng.standard_normal(D) / 4).astype(np.float32)
    pos = rng.randint(0, 4096, size=R).astype(np.float32)
    inv = 1.0 / (1e6 ** (np.arange(D // 2, dtype=np.float32) / (D // 2)))
    ang = (pos[:, None] * inv[None, :]).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    n_fast = -(-R // PAGE) + 1
    fast = rng.standard_normal((n_fast, LAYERS, 2, PAGE, Hkv, D)
                               ).astype(np.float32)
    pin = rng.standard_normal((n_fast + 2, LAYERS, 2, PAGE, Hkv, D)
                              ).astype(np.float32)
    at = rng.permutation(n_fast * PAGE)[:R]
    f_idx = (at // PAGE).astype(np.int32)
    off = (at % PAGE).astype(np.int32)
    p_idx = np.full(R, pin.shape[0], np.int32)
    if two_pools:
        to_pin = rng.rand(R) < 0.5
        p_idx = np.where(to_pin, f_idx, pin.shape[0]).astype(np.int32)
        f_idx = np.where(to_pin, n_fast, f_idx).astype(np.int32)
    f_idx[-1], p_idx[-1] = n_fast, pin.shape[0]
    return (q, k, v), w, cos, sin, fast, pin, f_idx, p_idx, off


def _torch_call(qkv, w, cos, sin, fast, pin, f_idx, p_idx, off, dtype,
                two_pools, dev="cpu"):
    """``rope_append`` on layer 1 of the pools: returns (q, fast, pin)."""
    t = {k: torch.from_numpy(a).to(dev, dtype) for k, a in w.items()}
    q, k, v = (torch.from_numpy(a).to(dev, dtype) for a in qkv)
    tf = torch.from_numpy(fast).to(dev, dtype)
    tp = torch.from_numpy(pin).to(dtype) if two_pools else None
    if tp is not None and dev != "cpu":
        tp = tp.pin_memory()
    i32 = [torch.from_numpy(a).to(dev) for a in (f_idx, p_idx, off)]
    qg = attention.rope_append(
        q, k, v, t.get("q_norm"), t.get("k_norm"),
        torch.from_numpy(cos).to(dev), torch.from_numpy(sin).to(dev),
        tf[:, 1], None if tp is None else tp[:, 1], i32[0],
        i32[1] if two_pools else None, i32[2])
    return qg, tf, tp


@pytest.mark.parametrize("G,D", [(1, 64), (4, 128), (8, 256), (2, 96)])
@pytest.mark.parametrize("two_pools", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", [False, True])
def test_plain_vs_jax_project_qkv_and_drop_scatters(norm, dtype, two_pools,
                                                    G, D):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.models import attention as jattn
    Hkv, R = 2, 6
    Hq = G * Hkv
    qkv, w, cos, sin, fast, pin, f_idx, p_idx, off = _inputs(
        7 + G + D, R, Hq, Hkv, D, norm, two_pools)
    # through project_raw / project_qkv from one-hot rows: x[r] picks
    # weight row r, so every projection is exact in both frameworks
    x = np.eye(R, dtype=np.float32)[:, None, :]
    t = {k: torch.from_numpy(a).to(dtype)
         for k, a in zip(("wq", "wk", "wv"), qkv)}
    raw = [a[:, 0] for a in attention.project_raw(
        t, torch.from_numpy(x).to(dtype))]
    qg, tf, tp = _torch_call([a.float().numpy() for a in raw], w, cos, sin,
                             fast, pin, f_idx, p_idx, off, dtype, two_pools)

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jw = {k: jnp.asarray(a).astype(jdt) for k, a in w.items()}
    p = jattn.AttnParams(*(jnp.asarray(a).astype(jdt) for a in qkv),
                         wo=jnp.zeros((Hq, D, 1), jdt), bq=None, bk=None,
                         bv=None, q_norm=jw.get("q_norm"),
                         k_norm=jw.get("k_norm"))
    q, k, v = jattn.project_qkv(p, jnp.asarray(x).astype(jdt),
                                jnp.asarray(cos)[:, None, :],
                                jnp.asarray(sin)[:, None, :])
    want_q = (q[:, 0] * D ** -0.5).reshape(R, Hkv, G, D)
    l = 1
    jf = jnp.asarray(fast).astype(jdt)
    jf = jf.at[f_idx, l, 0, off].set(k[:, 0], mode="drop")
    jf = jf.at[f_idx, l, 1, off].set(v[:, 0], mode="drop")
    pairs = [(tf, jf, fast, f_idx)]
    if two_pools:
        jp = jnp.asarray(pin).astype(jdt)
        jp = jp.at[p_idx, l, 0, off].set(k[:, 0], mode="drop")
        jp = jp.at[p_idx, l, 1, off].set(v[:, 0], mode="drop")
        pairs.append((tp, jp, pin, p_idx))
    assert qg.dtype == dtype and tuple(qg.shape) == (R, Hkv, G, D)
    for got, want in [(qg, want_q)] + [(t, j) for t, j, _, _ in pairs]:
        want = np.asarray(jax.device_get(want.astype(jnp.float32)))
        if dtype == torch.float32:
            assert_close(got, want, atol=1e-5, rtol=1e-4)
        else:
            assert_within_ulp(got, want, dtype)
    # placement is exact: untouched rows keep their bits, dropped rows
    # write nothing
    for t, _, orig, idx in pairs:
        ref = torch.from_numpy(orig).to(dtype)
        touched = torch.zeros(t.shape[:4], dtype=torch.bool)
        for r in range(R):
            if 0 <= idx[r] < t.shape[0]:
                touched[idx[r], l, :, off[r]] = True
        assert_same(t[~touched].float(), ref[~touched].float())


@pytest.mark.parametrize("arch", ["qwen3_4b", "qwen2_5_14b",
                                  "phi3_mini_3_8b"])
def test_plain_is_the_engines_former_composition(arch):
    """On CPU tensors ``rope_append`` gives the bits of what the engine
    ran before: ``project_qkv`` (norm + RoPE), ``q * D**-0.5`` grouped, and
    the masked append — at the heads of qwen3_4b (qk-norm), qwen2_5_14b
    (QKV bias) and phi3_mini_3_8b (head_dim 96) over a narrow d_model."""
    from repro_torch.configs import registry
    cfg = registry()[arch]
    rng = np.random.RandomState(4)
    d, Hq, Hkv, D = 32, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": rng.standard_normal((d, Hq, D)), "wk":
         rng.standard_normal((d, Hkv, D)), "wv":
         rng.standard_normal((d, Hkv, D))}
    if cfg.qkv_bias:
        p.update(bq=rng.standard_normal((Hq, D)),
                 bk=rng.standard_normal((Hkv, D)),
                 bv=rng.standard_normal((Hkv, D)))
    if cfg.qk_norm:
        p.update(q_norm=1 + rng.standard_normal(D) / 4,
                 k_norm=1 + rng.standard_normal(D) / 4)
    p = {k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()}
    R = 5
    x = torch.from_numpy(rng.standard_normal((R, 1, d)).astype(np.float32))
    cos, sin = layers.rope_angles(torch.from_numpy(
        rng.randint(0, 300, (R, 1)).astype(np.int32)), D, cfg.rope_theta)
    pool = torch.from_numpy(rng.standard_normal(
        (5, LAYERS, 2, PAGE, Hkv, D)).astype(np.float32))
    f_idx = torch.tensor([0, 3, 4, 1, 5], dtype=torch.int32)
    off = torch.tensor([1, 0, 3, 2, 0], dtype=torch.int32)
    before = pool.clone()
    q, k, v = attention.project_qkv(p, x, cos, sin)
    want_q = (q[:, 0] * D ** -0.5).reshape(R, Hkv, Hq // Hkv, D)
    KA.kv_append_plain(before[:, 0], None, f_idx, None, off, k[:, 0],
                       v[:, 0])
    q, k, v = attention.project_raw(p, x)
    got_q = attention.rope_append(q[:, 0], k[:, 0], v[:, 0], p.get("q_norm"),
                               p.get("k_norm"), cos[:, 0], sin[:, 0],
                               pool[:, 0], None, f_idx, None, off)
    assert_same(got_q, want_q)
    assert_same(pool, before)


def test_wrappers_on_cpu_never_launch_and_kv_append_refuses_the_card():
    """CPU tensors take the plain version (no launch counted, nothing
    built); the standalone append takes CPU tensors only, the kernel's
    wrapper CUDA tensors only."""
    from repro_torch.kernels import _build
    kernels.reset_launch_counts()
    _torch_call(*_inputs(3, 4, 4, 2, 16, True, True), torch.float32, True)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    assert _build._lib is None
    meta = torch.zeros((4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="qkv_rope_append"):
        KA.kv_append(meta, None, meta, None, meta, meta, meta)
    cpu = torch.zeros((4, 2, 16))
    with pytest.raises(ValueError, match="rope_append_plain"):
        KA.qkv_rope_append(cpu, cpu, cpu, None, None, cpu, cpu, cpu, None,
                           cpu, None, cpu, eps=1e-6)


# =============================================================================
# the kernel on the card
# =============================================================================

def _card_case(seed, R, G, D, dtype, norm, two_pools):
    """The kernel on the card and the plain version on the card, from the
    same inputs: ((q, fast, pin), (q, fast, pin))."""
    dev = cuda_device()
    args = _inputs(seed, R, G * 8, 8, D, norm, two_pools)
    got = _torch_call(*args, dtype, two_pools, dev=dev)
    qkv, w, cos, sin, fast, pin, f_idx, p_idx, off = args
    t = {k: torch.from_numpy(a).to(dev, dtype) for k, a in w.items()}
    q, k, v = (torch.from_numpy(a).to(dev, dtype) for a in qkv)
    tf = torch.from_numpy(fast).to(dev, dtype)
    tp = torch.from_numpy(pin).to(dtype) if two_pools else None
    i32 = [torch.from_numpy(a).to(dev) for a in (f_idx, p_idx, off)]
    want = attention.rope_append_plain(
        q, k, v, t.get("q_norm"), t.get("k_norm"),
        torch.from_numpy(cos).to(dev), torch.from_numpy(sin).to(dev),
        tf[:, 1], None if tp is None else tp[:, 1], i32[0],
        i32[1] if two_pools else None, i32[2])
    torch.cuda.synchronize()
    return got, (want, tf, tp)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("G,D", [(1, 64), (4, 128), (8, 256), (2, 96)])
@pytest.mark.parametrize("two_pools", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", [False, True])
def test_kernel_vs_plain_cuda(norm, dtype, two_pools, G, D):
    """One launch; q and both pools every bit equal with the norm off.
    With it on the kernel sums the D squares in another order than
    torch's mean: in bf16 the results stay within one ulp; in float32,
    where nothing rounds the difference away, the norm's scale moves by
    a few ulps and RoPE's differences of products carry that to values
    near zero, so float32 is held to atol = rtol = 1e-6 (the card read
    at most 9e-8).  The second pool is pinned host memory, written in
    place."""
    n0 = kernels.launch_counts()["qkv_rope_append"]
    (qg, tf, tp), (wq, wf, wp) = _card_case(11 + D, 8, G, D, dtype, norm,
                                            two_pools)
    assert kernels.launch_counts()["qkv_rope_append"] == n0 + 1
    if not norm:
        def check(a, b, _):
            assert_same(a.float().cpu(), b.float().cpu())
    elif dtype == torch.float32:
        def check(a, b, _):
            assert_close(a, b, atol=1e-6, rtol=1e-6)
    else:
        check = assert_within_ulp
    check(qg, wq, dtype)
    check(tf, wf, dtype)
    if two_pools:
        assert tp.is_pinned()
        check(tp, wp, dtype)


@pytest.mark.requires_cuda
def test_kernel_vs_plain_cuda_append_pattern():
    """The standalone append's card case, now through the fused kernel
    with no norm (bits equal): a pinned second pool, rows to each pool,
    a slot colliding across them, offsets at both page edges."""
    dev = cuda_device()
    rng = np.random.RandomState(11)
    Hkv, D, G = 8, 128, 4
    tf = torch.from_numpy(rng.standard_normal((6, 3, 2, 16, Hkv, D)).astype(
        np.float32)).to(dev, torch.bfloat16)
    tp = torch.from_numpy(rng.standard_normal((9, 3, 2, 16, Hkv, D)).astype(
        np.float32)).to(torch.bfloat16).pin_memory()
    k = torch.from_numpy(rng.standard_normal((4, Hkv, D)).astype(
        np.float32)).to(dev, torch.bfloat16)
    v = -k
    q = torch.cat([k] * G, dim=1)
    ang = torch.from_numpy(rng.rand(4, D // 2).astype(np.float32)).to(dev)
    cos, sin = torch.cos(ang), torch.sin(ang)
    f_idx = torch.tensor([6, 2, 6, 5], dtype=torch.int32, device=dev)
    p_idx = torch.tensor([2, 9, 8, 9], dtype=torch.int32, device=dev)
    off = torch.tensor([15, 0, 3, 7], dtype=torch.int32, device=dev)
    wf, wp = tf.clone(), tp.clone()
    args = (q, k, v, None, None, cos, sin)
    got = attention.rope_append(*args, tf[:, 1], tp[:, 1], f_idx, p_idx, off)
    want = attention.rope_append_plain(*args, wf[:, 1], wp[:, 1], f_idx, p_idx,
                                    off)
    torch.cuda.synchronize()
    assert_same(got.float().cpu(), want.float().cpu())
    assert_same(tf.float().cpu(), wf.float().cpu())
    assert_same(tp.float(), wp.float())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_bits_alone_in_a_batch_and_in_a_bucket_cuda(dtype):
    """qwen3_4b's widths with qk-norm: row 0's q and K/V bits are the same
    when it runs alone, in a batch of 8 and in a 256-row bucket."""
    dev = cuda_device()
    qkv, w, cos, sin, fast, pin, f_idx, p_idx, off = _inputs(
        5, 256, 32, 8, 128, True, False)
    outs = []
    for R in (1, 8, 256):
        qg, tf, _ = _torch_call([a[:R] for a in qkv], w, cos[:R], sin[:R],
                                fast, pin, f_idx[:R], p_idx[:R], off[:R],
                                dtype, False, dev=dev)
        torch.cuda.synchronize()
        outs.append((qg[0].clone(), tf[f_idx[0], 1, :, off[0]].clone()))
    for q, kv in outs[1:]:
        assert torch.equal(q, outs[0][0]) and torch.equal(kv, outs[0][1])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("two_pools", [False, True])
def test_graph_replay_equals_eager_cuda(two_pools):
    """A CUDA graph of one call, replayed on new inputs, gives the eager
    call's bits (no host sync, no allocation inside the C entry)."""
    dev = cuda_device()
    qkv, w, cos, sin, fast, pin, f_idx, p_idx, off = _inputs(
        6, 8, 32, 8, 128, True, two_pools)
    dt = torch.bfloat16
    t = {k: torch.from_numpy(a).to(dev, dt) for k, a in w.items()}
    q, k, v = (torch.from_numpy(a).to(dev, dt) for a in qkv)
    tf = torch.from_numpy(fast).to(dev, dt)
    tp = torch.from_numpy(pin).to(dt).pin_memory() if two_pools else None
    i32 = [torch.from_numpy(a).to(dev) for a in (f_idx, p_idx, off)]
    tc, ts = torch.from_numpy(cos).to(dev), torch.from_numpy(sin).to(dev)

    def call():
        return attention.rope_append(
            q, k, v, t["q_norm"], t["k_norm"], tc, ts, tf[:, 0],
            None if tp is None else tp[:, 0], i32[0],
            i32[1] if two_pools else None, i32[2])
    call()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = call()
    for a in (q, k, v):                     # new inputs, same buffers
        a.mul_(-1.5)
    g.replay()
    torch.cuda.synchronize()
    replayed = (out.clone(), tf.clone(), None if tp is None else tp.clone())
    eager = call()
    torch.cuda.synchronize()
    assert torch.equal(replayed[0], eager)
    assert torch.equal(replayed[1], tf)
    if two_pools:
        assert torch.equal(replayed[2], tp)
