"""K8 (``kernels.flash_attention``) at head dim 256 (gemma3) and 64
(musicgen).

On the CPU the wrapper's plain version at D 256 is held against the
Pallas kernel in interpret mode (which pads nothing at D 256) and the
model's ``sdpa``, causal, with a window and non-causal, GQA 8/2 and MHA,
and against the Pallas oracle with ``seq_len``; floats within
``ATOL``/``RTOL`` of ``helpers.torch_parity``.

The ``requires_cuda`` cases hold both CUDA entries against the plain
version on the card at D 64 and 256 (and D 136, a width of the D-256
kernels that is not a whole number of 64-column boxes): causal, window,
G 1 to 4, ``seq_len``, non-causal, ragged S; float32 within 1e-5, bf16
within 1e-2 (K8's tolerances), four cases with more work items than an
H100 has SMs; the bf16 kernel past D 128 gives the same bits on repeated
runs and in a graph replay with a CTA taking several items.  The bf16
entry also at the edges of its three kernels (D 8, 56 on the D <= 64
one, 72, 128 on the D <= 128 one); the
float32 entry past D 128 (the ``wgmma`` kernel and its pre-pass) on
strided views whose rows are not 16-byte aligned; a CUDA-graph replay
equal to the eager call for each new kernel; the float32 D-256 launch
plan; and a D past 256 refused before any launch.  They skip here.  JAX
is imported inside the tests that use it.
"""
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_close, cap_threads, cuda_device
from repro_torch import kernels
from repro_torch.kernels import flash_attention as K8

cap_threads()


def _qkv(B, S, Hq, Hkv, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((B, S, Hq, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32))


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.asarray(a)).to(device) for a in arrays]


@pytest.mark.parametrize("B,S,Hq,Hkv", [(1, 128, 8, 2), (2, 64, 2, 2)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32),
                                           (False, 0)])
def test_plain_d256_vs_pallas_interpret(B, S, Hq, Hkv, causal, window):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention
    from repro.models import attention as jattn
    q, k, v = _qkv(B, S, Hq, Hkv, 256, seed=S + Hq)
    out = K8.flash_attention(*_t(q, k, v), causal=causal, window=window)
    assert out.shape == (B, S, Hq, 256) and out.dtype == torch.float32
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref = flash_attention(jq, jk, jv, causal=causal, window=window, bq=64,
                          bk=64, interpret=True)
    assert_close(out, ref)
    if causal:
        pos = jnp.arange(S, dtype=jnp.int32)[None]
        bias = jattn._mask_bias(pos, pos, window if window else None)
        assert_close(out, jattn.sdpa(jq, jk, jv, bias))


@pytest.mark.parametrize("causal,window,seq_len", [(True, 0, 40),
                                                   (False, 0, 17),
                                                   (True, 8, 33)])
def test_plain_d256_seq_len_matches_pallas_ref(causal, window, seq_len):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention_ref
    B, S, Hq, Hkv, D = 2, 48, 4, 2, 256
    q, k, v = _qkv(B, S, Hq, Hkv, D, seed=3)
    out = K8.flash_attention(*_t(q, k, v), causal=causal, window=window,
                             seq_len=seq_len)
    qf = q.transpose(0, 2, 1, 3).reshape(B * Hq, S, D) * D ** -0.5
    kf = k.transpose(0, 2, 1, 3).reshape(B * Hkv, S, D)
    vf = v.transpose(0, 2, 1, 3).reshape(B * Hkv, S, D)
    ref = flash_attention_ref(jnp.asarray(qf), jnp.asarray(kf),
                              jnp.asarray(vf), causal=causal, window=window,
                              seq_len=seq_len)
    assert_close(out, np.asarray(ref).reshape(B, Hq, S, D)
                 .transpose(0, 2, 1, 3))


# ---------------------------------------------------------------- the card

CARD_CASES = [
    # B, S, Hq, Hkv, causal, window, seq_len
    (2, 128, 8, 4, True, 0, None),          # gemma3's GQA 2, causal
    (1, 300, 8, 4, True, 70, None),         # a window, ragged S
    (2, 200, 4, 1, True, 0, 150),           # GQA 4, seq_len
    (1, 97, 4, 4, False, 0, None),          # non-causal, ragged S
    (1, 260, 6, 3, False, 40, 230),         # non-causal window, seq_len
    (2, 517, 4, 2, True, 0, 400),           # G 2, ragged S, seq_len
    (1, 333, 6, 2, True, 100, 300),         # G 3, a window that cuts tiles
    (1, 390, 3, 3, True, 200, None),        # G 1, window, ragged S
    (3, 150, 6, 2, False, 0, 129),          # G 3, non-causal, seq_len
    # more items than an H100's 132 SMs: past D 128 a CTA takes two to
    # four items (Q reloaded, barrier phases and the snake across items)
    (2, 1100, 16, 8, True, 0, 1000),        # G 2, seq_len, 288 items
    (2, 1100, 16, 16, True, 300, None),     # G 1, a window that cuts tiles
    (2, 1100, 24, 8, True, 200, 1050),      # G 3, window, seq_len, 432
    (1, 1100, 32, 16, False, 0, 1037),      # G 2, non-causal, seq_len
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("D", [64, 136, 256])
@pytest.mark.parametrize("B,S,Hq,Hkv,causal,window,seq_len", CARD_CASES)
def test_kernel_vs_plain_d64_d256_cuda(dtype, tol, D, B, S, Hq, Hkv, causal,
                                       window, seq_len):
    dev = cuda_device()
    q, k, v = (t.to(dtype) for t in _t(*_qkv(B, S, Hq, Hkv, D, seed=D + S),
                                       device=dev))
    before = kernels.launch_counts()["flash_attention"]
    out = K8.flash_attention(q, k, v, causal=causal, window=window,
                             seq_len=seq_len)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == before + 1
    ref = K8.flash_attention_plain(q, k, v, causal=causal, window=window,
                                   seq_len=seq_len)
    assert out.dtype == dtype and out.shape == (B, S, Hq, D)
    assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("D", [8, 56, 72, 128])
@pytest.mark.parametrize("B,S,Hq,Hkv,causal,window,seq_len", CARD_CASES)
def test_bf16_kernel_edges_vs_plain_cuda(D, B, S, Hq, Hkv, causal, window,
                                        seq_len):
    """The bf16 entry at the edges of its kernels' ranges (D 8 and 56 on
    the D <= 64 kernel, 72 and 128 on the D <= 128 one) within 1e-2 of
    the plain version: causal, windowed, ``seq_len`` < Sk, non-causal."""
    dev = cuda_device()
    q, k, v = (t.to(torch.bfloat16) for t in _t(
        *_qkv(B, S, Hq, Hkv, D, seed=D + S), device=dev))
    before = kernels.launch_counts()["flash_attention"]
    out = K8.flash_attention(q, k, v, causal=causal, window=window,
                             seq_len=seq_len)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == before + 1
    ref = K8.flash_attention_plain(q, k, v, causal=causal, window=window,
                                   seq_len=seq_len)
    assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("D,offset", [(136, 1), (256, 1), (256, 0)])
def test_f32_wide_strided_unaligned_views_cuda(D, offset):
    """Past D 128 the float32 entry reads q, k and v through their
    strides whatever their alignment (a fused-qkv view, a base one float
    off): within 1e-5 of the plain version, causal and windowed."""
    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(D + offset)
    B, S, Hq, Hkv = 2, 150, 4, 2
    flat = torch.randn(offset + B * S * (Hq + 2 * Hkv) * D, device=dev,
                       generator=gen)
    qkv = flat[offset:].view(B, S, Hq + 2 * Hkv, D)
    q, k, v = qkv[:, :, :Hq], qkv[:, :, Hq:Hq + Hkv], qkv[:, :, Hq + Hkv:]
    for window in (0, 40):
        out = K8.flash_attention(q, k, v, window=window)
        ref = K8.flash_attention_plain(q, k, v, window=window)
        torch.cuda.synchronize()
        assert_close(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 136, 256])
def test_graph_replay_equals_eager_cuda(dtype, D):
    """Captured in a CUDA graph, either entry at D 64, 136 and 256 replays
    the bits of an eager call; two eager calls give equal bits."""
    dev = cuda_device()
    q, k, v = (t.to(dtype) for t in _t(*_qkv(1, 333, 8, 4, D, seed=5),
                                       device=dev))

    def fn():
        return K8.flash_attention(q, k, v, window=100)
    eager = fn()
    assert torch.equal(fn(), eager)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window", [(2, 700, 8, 4, 256, 0),
                                                 (1, 900, 6, 2, 256, 256),
                                                 (2, 300, 4, 4, 136, 0),
                                                 (2, 1100, 16, 8, 256, 300),
                                                 (2, 1100, 24, 8, 136, 0)])
def test_bf16_d256_bits_repeat_cuda(B, S, Hq, Hkv, D, window):
    """The persistent bf16 kernel past D 128 gives the same bits on three
    runs (each item's sums in one fixed order, whichever CTA takes it;
    the last two shapes give a CTA two to four items)."""
    dev = cuda_device()
    q, k, v = (t.to(torch.bfloat16) for t in _t(
        *_qkv(B, S, Hq, Hkv, D, seed=D + S), device=dev))
    first = K8.flash_attention(q, k, v, window=window)
    for _ in range(2):
        assert torch.equal(K8.flash_attention(q, k, v, window=window), first)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("D", [136, 256])
def test_bf16_d256_many_items_graph_replay_cuda(D):
    """Past D 128 the persistent bf16 kernel with more items than SMs (B
    2, S 1100, 16/8 heads: 288 items), a window that cuts tiles and
    ``seq_len`` < S: a CUDA-graph replay gives the eager call's bits, and
    both are within 1e-2 of the plain version."""
    dev = cuda_device()
    q, k, v = (t.to(torch.bfloat16) for t in _t(
        *_qkv(2, 1100, 16, 8, D, seed=D + 7), device=dev))

    def fn():
        return K8.flash_attention(q, k, v, window=300, seq_len=1000)
    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    ref = K8.flash_attention_plain(q, k, v, window=300, seq_len=1000)
    assert_close(eager.float(), ref.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,S,Hq,D", [(4, 2000, 8, 256), (1, 77, 2, 136)])
def test_f32_d256_launch_plan_cuda(B, S, Hq, D):
    """Past D 128 the float32 entry's main kernel takes 64 query rows a
    CTA in three warpgroups (two consumers, each half of D, and a
    producer), one CTA an SM: Q's big term (64 KB), one 32-key tile of K's
    and one of V^T's two terms (64 KB each) and two double-buffered
    partial-S exchanges (32 KB), at D padded to 256 whatever D is."""
    cuda_device()
    info = K8.launch_info(B, S, Hq, D)
    assert info["threads"] == 384, info
    assert info["ctas"] == B * Hq * -(-S // 64), info
    assert info["smem_bytes"] == 1024 + 3 * 65536 + 32768 + 32, info
    assert info["ctas_per_sm"] == 1, info


@pytest.mark.parametrize("D", [8, 16, 56, 64])
def test_folded_exponent_of_masked_rows(D):
    """The D <= 64 bf16 kernel takes S unscaled and computes a
    probability as exp2(fmaf(x, scale, -m * scale)).  It masks with
    -2**100, whose product with the scale is exact: in a row that has
    seen only masked keys (x = m = -2**100) the exponent is exactly 0 and
    p is 1, as the unfolded arithmetic gives.  With -1e30 the fmaf keeps
    the rounding error of m * scale, ~1e22, and p is 0 or inf: the
    control."""
    scale = np.float32(D ** -0.5 * np.log2(np.e))

    def folded(x):
        m_scaled = np.float32(x * scale)                # ms = m * scale
        return np.float32(np.float64(x) * np.float64(scale)
                          - np.float64(m_scaled))       # fmaf, exact
    assert folded(np.float32(-2.0 ** 100)) == 0
    assert abs(folded(np.float32(-1e30))) > 1e15


def test_f32_scratch_floats():
    """The scratch of the float32 entry past D 128: K's and V^T's two
    terms at D 256 in 32-key tiles, at least one tile, per kv head."""
    assert K8.f32_scratch_floats(4, 2000, 4) == 2 * 16 * 63 * 2 * 32 * 256
    assert K8.f32_scratch_floats(1, 32, 2) == 2 * 2 * 1 * 2 * 32 * 256
    assert K8.f32_scratch_floats(2, 33, 1) == 2 * 2 * 2 * 2 * 32 * 256
    assert K8.f32_scratch_floats(1, 0, 1) == 2 * 1 * 1 * 2 * 32 * 256


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_d_past_256_refused_on_the_card_cuda(dtype):
    dev = cuda_device()
    q, k, v = (t.to(dtype) for t in _t(*_qkv(1, 16, 2, 2, 264, seed=6),
                                       device=dev))
    before = kernels.launch_counts()["flash_attention"]
    with pytest.raises(ValueError, match="D=264"):
        K8.flash_attention(q, k, v)
    assert kernels.launch_counts()["flash_attention"] == before
    # the plain version takes it
    assert K8.flash_attention_plain(q, k, v).shape == (1, 16, 2, 264)
