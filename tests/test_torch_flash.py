"""The port's attention math and kernel K8 (``kernels.flash_attention``)
against the JAX package, in float32 on the same numpy inputs.

K8's plain version (what the wrapper runs on CPU tensors) is held
against the Pallas kernel in interpret mode and against the model's
``sdpa`` over the sweep of ``tests/test_kernels.py`` (causal, window 32,
non-causal; GQA 4/2 and 8/2, D 64, 80, 128), float32 half;
``attention``, ``sdpa_grouped`` and the dense/ring ``decode_attention``
against JAX's with weights carried over.  Floats within ``ATOL``/``RTOL``
of ``helpers.torch_parity`` except where a test states its own limit.
``q_start`` (a rank's rows of the sequence) is held against JAX's
``sdpa`` over the shifted mask and against the rows of a whole run.
The ``requires_cuda`` cases hold the CUDA kernel against the plain
version on the card (every body at three ``q_start``) and skip here.

JAX is imported inside the tests that use it, so the CUDA cases also
collect on a machine that has only torch.
"""
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_close, cap_threads, cuda_device
from repro_torch import kernels
from repro_torch.kernels import flash_attention as K8
from repro_torch.models import attention

cap_threads()

SWEEP = [(2, 128, 4, 2, 64), (1, 256, 4, 4, 64), (2, 96, 8, 2, 80),
         (1, 64, 6, 3, 128)]
MASKS = [(True, 0), (True, 32), (False, 0)]


def _jnp():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    return jnp


def _qkv(B, Sq, Sk, Hq, Hkv, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((B, Sq, Hq, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32))


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.asarray(a)).to(device) for a in arrays]


@pytest.mark.parametrize("B,S,Hq,Hkv,D", SWEEP)
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_attention_plain_vs_pallas(B, S, Hq, Hkv, D, causal, window):
    """The wrapper on CPU tensors against the Pallas kernel in interpret
    mode (bq = bk = 64, as ``test_kernels.py`` runs it) and, for the causal
    masks, against the model's ``sdpa`` with ``_mask_bias``."""
    jnp = _jnp()
    from repro.kernels.flash_attention import flash_attention
    from repro.models import attention as jattn
    q, k, v = _qkv(B, S, S, Hq, Hkv, D, seed=0)
    out = K8.flash_attention(*_t(q, k, v), causal=causal, window=window)
    assert out.shape == (B, S, Hq, D) and out.dtype == torch.float32
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
def test_flash_attention_seq_len_matches_pallas_ref(causal, window, seq_len):
    """Keys at and past ``seq_len`` are masked, as in the Pallas oracle
    (flattened [B*H, S, D] layout, q pre-scaled there)."""
    jnp = _jnp()
    from repro.kernels.flash_attention import flash_attention_ref
    B, S, Hq, Hkv, D = 2, 48, 4, 2, 32
    q, k, v = _qkv(B, S, S, Hq, Hkv, D, seed=1)
    out = K8.flash_attention(*_t(q, k, v), causal=causal, window=window,
                             seq_len=seq_len)
    qf = (q.transpose(0, 2, 1, 3).reshape(B * Hq, S, D) * D ** -0.5)
    kf = k.transpose(0, 2, 1, 3).reshape(B * Hkv, S, D)
    vf = v.transpose(0, 2, 1, 3).reshape(B * Hkv, S, D)
    ref = flash_attention_ref(jnp.asarray(qf), jnp.asarray(kf),
                              jnp.asarray(vf), causal=causal, window=window,
                              seq_len=seq_len)
    ref = np.asarray(ref).reshape(B, Hq, S, D).transpose(0, 2, 1, 3)
    assert_close(out, ref)


# queries at positions start .. start + Sq - 1 against all Sk keys: a
# rank's rows of the sequence in the sharded prefill's context mode
Q_START = [(0, 32, 128, 0), (64, 32, 128, 0), (37, 29, 128, 16),
           (96, 32, 128, 40), (5, 59, 64, 0)]


@pytest.mark.parametrize("start,Sq,Sk,window", Q_START)
@pytest.mark.parametrize("Hq,Hkv,D", [(4, 2, 64), (6, 3, 80)])
def test_flash_attention_q_start_matches_jax_sdpa(start, Sq, Sk, window, Hq,
                                                  Hkv, D):
    """``q_start`` on CPU tensors (the plain version) against JAX's
    ``sdpa`` over ``_mask_bias(q_pos + start, k_pos, window)``, and equal
    to those rows of the whole sequence's result."""
    jnp = _jnp()
    from repro.models import attention as jattn
    q, k, v = _qkv(2, Sk, Sk, Hq, Hkv, D, seed=4)
    qs = q[:, start:start + Sq]
    out = K8.flash_attention(*_t(qs, k, v), window=window, q_start=start)
    assert out.shape == (2, Sq, Hq, D)
    q_pos = jnp.arange(Sq, dtype=jnp.int32)[None] + start
    k_pos = jnp.arange(Sk, dtype=jnp.int32)[None]
    bias = jattn._mask_bias(q_pos, k_pos, window if window else None)
    assert_close(out, jattn.sdpa(*(jnp.asarray(a) for a in (qs, k, v)),
                                 bias))
    whole = K8.flash_attention(*_t(q, k, v), window=window)
    assert_close(out, whole[:, start:start + Sq], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("causal,window,seq_len", [(True, 0, 128),
                                                   (True, 24, 100),
                                                   (False, 40, 128),
                                                   (False, 0, 77)])
def test_flash_attention_q_start_pairs_and_plain_mask(causal, window,
                                                      seq_len):
    """``key_pairs`` and the meta branch count the scored pairs of the
    rows at ``q_start`` (not of a prefix of that length), and the plain
    version's non-causal window is measured from the same positions."""
    start, Sq, Sk = 40, 48, 128
    qp = np.arange(start, start + Sq)[:, None]
    kp = np.arange(Sk)[None]
    ok = np.broadcast_to(kp < seq_len, (Sq, Sk))
    if causal:
        ok = ok & (kp <= qp)
    if window:
        ok = ok & (qp - kp < window)
    assert K8.key_pairs(Sq, Sk, causal, window, seq_len, start) == ok.sum()
    kernels.reset_meta_flops()
    m = torch.empty((1, Sq, 2, 16), device="meta")
    kv = torch.empty((1, Sk, 2, 16), device="meta")
    K8.flash_attention(m, kv, kv, causal=causal, window=window,
                       seq_len=seq_len, q_start=start)
    assert kernels.meta_flops()["flash_attention"] == 4.0 * 2 * 16 * ok.sum()
    q, k, v = _qkv(1, Sq, Sk, 2, 2, 16, seed=6)
    out = K8.flash_attention(*_t(q, k, v), causal=causal, window=window,
                             seq_len=seq_len, q_start=start)
    bias = np.where(ok, 0.0, attention.NEG_INF).astype(np.float32)
    want = attention.sdpa(*_t(q, k, v), torch.from_numpy(bias)[None])
    assert_close(out, want)
    with pytest.raises(ValueError, match="q_start"):
        K8.flash_attention(*_t(q, k, v), q_start=-1)


def test_flash_attention_refuses_bad_shapes():
    """Shapes that do not fit are refused on any device; a head dim past
    the kernels' MAX_D (256) only on the card: CPU tensors take the plain
    version at any D (D 288 here, against the model's ``sdpa``)."""
    q, k, v = _t(*_qkv(1, 8, 8, 3, 2, 16, seed=2))
    with pytest.raises(ValueError, match="multiple of Hkv"):
        K8.flash_attention(q, k, v)
    q, k, v = _t(*_qkv(1, 8, 8, 2, 2, 288, seed=2))
    pos = torch.arange(8)
    assert_close(K8.flash_attention(q, k, v),
                 attention.sdpa(q, k, v, attention._mask_bias(pos, pos,
                                                              None)[None]))
    q, k, v = _t(*_qkv(1, 8, 8, 2, 2, 16, seed=2))
    with pytest.raises(ValueError, match="seq_len"):
        K8.flash_attention(q, k, v, seq_len=9)


@pytest.mark.parametrize("D", [16, 64, 80, 112, 128])
def test_tma_strides_accepts_model_shapes(D):
    """The bf16 kernel's TMA check takes every head dim the models and the
    tests use, contiguous, and returns the (B, S, H) element strides."""
    t = torch.zeros((2, 70, 4, D), dtype=torch.bfloat16)
    assert K8.tma_strides(t) == (70 * 4 * D, 4 * D, D)


def test_tma_strides_accepts_fused_qkv_views():
    """q, k, v as strided views of a fused [B, S, 3, H, D] bf16 tensor
    pass with their own strides; size-1 dims get the contiguous stride."""
    qkv = torch.zeros((2, 70, 3, 4, 112), dtype=torch.bfloat16)
    for i in range(3):
        view = qkv[:, :, i]
        assert not view.is_contiguous()
        assert K8.tma_strides(view, "k") == (70 * 3 * 4 * 112, 3 * 4 * 112,
                                             112)
    one = torch.zeros((1, 1, 1, 64), dtype=torch.bfloat16)
    assert K8.tma_strides(one) == (64, 64, 64)


@pytest.mark.parametrize("case", ["D100", "offset", "stride"])
def test_tma_strides_refuses_what_tma_cannot_address(case):
    """D = 100 (not a multiple of 8), a view offset by one element (base
    not 16-byte aligned) and an S stride of 100 elements are refused with
    a message."""
    bf = torch.bfloat16
    if case == "D100":
        t, match = torch.zeros((1, 8, 2, 100), dtype=bf), "D=100"
    elif case == "offset":
        flat = torch.zeros(2 * 64 * 4 * 64 + 1, dtype=bf)
        t, match = flat[1:].view(2, 64, 4, 64), "base address"
    else:
        t, match = torch.zeros((1, 8, 100), dtype=bf)[..., :64].reshape(
            1, 8, 1, 64), "stride 100"
    with pytest.raises(ValueError, match=match):
        K8.tma_strides(t)


@pytest.mark.parametrize("window,Hq,Hkv", [(None, 4, 2), (0, 4, 4),
                                           (5, 4, 2)])
def test_mask_bias_and_sdpa_match_jax(window, Hq, Hkv):
    jnp = _jnp()
    from repro.models import attention as jattn
    rng = np.random.RandomState(3)
    pos = np.stack([np.arange(11), np.arange(3, 14)]).astype(np.int32)
    bias = attention._mask_bias(torch.from_numpy(pos),
                                torch.from_numpy(pos), window)
    jbias = jattn._mask_bias(jnp.asarray(pos), jnp.asarray(pos), window)
    assert_close(bias, jbias, atol=0, rtol=0)
    q, k, v = _qkv(2, 11, 11, Hq, Hkv, 16, seed=4)
    assert_close(attention.sdpa(*_t(q, k, v), bias),
                 jattn.sdpa(*(jnp.asarray(a) for a in (q, k, v)), jbias))
    cap = float(rng.uniform(5, 20))
    assert_close(attention.sdpa(*_t(q, k, v), bias, soft_cap=cap),
                 jattn.sdpa(*(jnp.asarray(a) for a in (q, k, v)), jbias,
                            soft_cap=cap))
    gb = np.where(rng.rand(2, 3, 11) < 0.8, 0.0, -2e38).astype(np.float32)
    gb[..., 0] = 0.0
    qd = q[:, :3]
    assert_close(attention.sdpa_grouped(*_t(qd, k, v, gb)),
                 jattn.sdpa_grouped(*(jnp.asarray(a)
                                      for a in (qd, k, v, gb))))


def _attn_params(d, Hq, Hkv, Dh, seed):
    """JAX attention weights and their port dict (float32)."""
    import jax
    from repro.models import attention as jattn
    jp = jattn.init_attn_params(jax.random.PRNGKey(seed), d, Hq, Hkv, Dh)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp._asdict().items()
          if v is not None}
    return jp, tp


def _rope(S0, S, Dh, B):
    jnp = _jnp()
    from repro.models import layers as jlayers
    from repro_torch.models import layers
    pos = np.broadcast_to(np.arange(S0, S0 + S, dtype=np.int32), (B, S))
    c, s = layers.rope_angles(torch.from_numpy(pos.copy()), Dh, 1e4)
    jc, js = jlayers.rope_angles(jnp.asarray(pos), Dh, 1e4)
    return pos, (c, s), (jc, js)


@pytest.mark.parametrize("window,Hkv", [(None, 4), (32, 2), (None, 2)])
def test_attention_matches_jax(window, Hkv):
    """Full causal self-attention over a prompt on K8 (its plain version
    here) against JAX ``attention`` with the same weights: output and the
    projected K/V."""
    jnp = _jnp()
    from repro.models import attention as jattn
    B, S, d, Hq, Dh = 2, 45, 64, 4, 16
    jp, tp = _attn_params(d, Hq, Hkv, Dh, seed=5)
    x = np.random.RandomState(6).standard_normal((B, S, d)).astype(
        np.float32)
    pos, (c, s), (jc, js) = _rope(0, S, Dh, B)
    out, (k, v) = attention.attention(tp, torch.from_numpy(x),
                                      torch.from_numpy(pos.copy()), c, s,
                                      window=window)
    jout, (jk, jv) = jattn.attention(jp, jnp.asarray(x), jnp.asarray(pos),
                                     jc, js, window=window)
    assert_close(out, jout)
    assert_close(k, jk)
    assert_close(v, jv)
    with pytest.raises(NotImplementedError, match="soft cap"):
        attention.attention(tp, torch.from_numpy(x),
                            torch.from_numpy(pos.copy()), c, s, soft_cap=30.0)


@pytest.mark.parametrize("Smax,window", [(24, None), (8, None), (8, 6)])
def test_decode_attention_matches_jax(Smax, window):
    """Five decode steps against a dense (Smax > context) and a ring
    cache (Smax < context, slots reused at position % Smax), with and
    without a window: outputs and every cache array, the port's written
    in place."""
    jnp = _jnp()
    from repro.models import attention as jattn
    B, d, Hq, Hkv, Dh = 2, 64, 4, 2, 16
    jp, tp = _attn_params(d, Hq, Hkv, Dh, seed=7)
    rng = np.random.RandomState(8)
    kc = np.zeros((B, Smax, Hkv, Dh), np.float32)
    pc = np.full((B, Smax), -1, np.int32)
    t_k, t_v, t_p = _t(kc, kc.copy(), pc)
    j_k, j_v, j_p = jnp.asarray(kc), jnp.asarray(kc), jnp.asarray(pc)
    for step in range(10):
        x = rng.standard_normal((B, 1, d)).astype(np.float32)
        pos, (c, s), (jc, js) = _rope(step, 1, Dh, B)
        out, k2, v2, p2 = attention.decode_attention(
            tp, torch.from_numpy(x), t_k, t_v, t_p,
            torch.from_numpy(pos.copy()), c, s, window=window)
        assert k2 is t_k and v2 is t_v and p2 is t_p
        jout, j_k, j_v, j_p = jattn.decode_attention(
            jp, jnp.asarray(x), j_k, j_v, j_p, jnp.asarray(pos), jc, js,
            window=window)
        assert_close(out, jout)
        assert_close(t_k, j_k)
        assert_close(t_v, j_v)
        assert_close(t_p, j_p, atol=0, rtol=0)


# =============================================================================
# the CUDA kernel on the card
# =============================================================================

@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("B,Sq,Hq,Hkv,D,causal,window,seq_len", [
    (2, 128, 4, 2, 64, True, 0, None), (1, 200, 4, 4, 112, True, 0, None),
    (2, 96, 8, 2, 80, True, 32, None), (1, 64, 6, 3, 128, False, 0, None),
    (1, 130, 4, 1, 128, True, 0, 100), (2, 77, 2, 2, 16, False, 0, 50),
    (1, 300, 4, 2, 64, True, 70, None)])
def test_flash_attention_kernel_vs_plain_cuda(dtype, tol, B, Sq, Hq, Hkv, D,
                                              causal, window, seq_len):
    """K8 against its plain version on the same card inputs.  Both do
    float32 math on the same rounded inputs; float32 output within 1e-5,
    bf16 output within one bf16 ulp of values below 2 (1e-2)."""
    dev = cuda_device()
    q, k, v = _t(*_qkv(B, Sq, Sq, Hq, Hkv, D, seed=9), device=dev)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = kernels.launch_counts()["flash_attention"]
    out = K8.flash_attention(q, k, v, causal=causal, window=window,
                             seq_len=seq_len)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == before + 1
    ref = K8.flash_attention_plain(q, k, v, causal=causal, window=window,
                                   seq_len=seq_len)
    assert out.dtype == dtype
    assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


# (dtype, D, Hq, Hkv, window): one case for each body -- bf16 D <= 64,
# D <= 128 (112 and 128), the persistent D-256 kernel with and without a
# window, float32 up to D 128 (mma.sync) and past it (wgmma, pre-pass)
Q_START_BODIES = [(torch.bfloat16, 64, 4, 4, 0), (torch.bfloat16, 112, 4, 2, 0),
                  (torch.bfloat16, 128, 4, 1, 0), (torch.bfloat16, 256, 4, 2, 0),
                  (torch.bfloat16, 256, 4, 2, 100), (torch.float32, 128, 4, 2, 0),
                  (torch.float32, 256, 4, 2, 0)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype,D,Hq,Hkv,window", Q_START_BODIES)
@pytest.mark.parametrize("start", [0, 128, 77])
def test_flash_attention_q_start_vs_plain_cuda(dtype, D, Hq, Hkv, window,
                                               start):
    """Each K8 body on a shard of 150 query rows at ``q_start`` 0, a tile
    multiple and an unaligned offset, against all 400 keys: within the
    plain version's tolerance (bf16 1e-2, float32 1e-5), one launch."""
    dev = cuda_device()
    Sq, Sk = 150, 400
    q, k, v = _t(*_qkv(2, Sk, Sk, Hq, Hkv, D, seed=12), device=dev)
    q, k, v = (t.to(dtype) for t in (q[:, start:start + Sq], k, v))
    before = kernels.launch_counts()["flash_attention"]
    out = K8.flash_attention(q, k, v, window=window, q_start=start)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == before + 1
    ref = K8.flash_attention_plain(q, k, v, window=window, q_start=start)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.requires_cuda
def test_flash_attention_kernel_reads_strided_views_cuda():
    """q, k, v as non-contiguous views of a fused [B, S, 3, H, D] tensor:
    the kernel takes their strides, with no copy."""
    dev = cuda_device()
    qkv = torch.randn((2, 70, 3, 4, 112), device=dev)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    out = K8.flash_attention(q, k, v)
    ref = K8.flash_attention_plain(q.contiguous(), k.contiguous(),
                                   v.contiguous())
    torch.cuda.synchronize()
    assert_close(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.requires_cuda
def test_flash_attention_bf16_reads_strided_views_cuda():
    """The bf16 kernel's TMA maps over non-contiguous q, k, v views of a
    fused [B, S, 3, H, D] tensor match the plain version on contiguous
    copies, within the bf16 tolerance."""
    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(3)
    qkv = torch.randn((2, 70, 3, 4, 112), device=dev, generator=gen).to(
        torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    out = K8.flash_attention(q, k, v)
    ref = K8.flash_attention_plain(q.contiguous(), k.contiguous(),
                                   v.contiguous())
    torch.cuda.synchronize()
    assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.requires_cuda
def test_flash_attention_bf16_refuses_unaligned_view_cuda():
    """A bf16 view the TMA maps cannot address raises before any launch."""
    dev = cuda_device()
    flat = torch.zeros(64 * 2 * 64 + 1, dtype=torch.bfloat16, device=dev)
    q = flat[1:].view(1, 64, 2, 64)
    before = kernels.launch_counts()["flash_attention"]
    with pytest.raises(ValueError, match="base address"):
        K8.flash_attention(q, q, q)
    assert kernels.launch_counts()["flash_attention"] == before


@pytest.mark.requires_cuda
@pytest.mark.parametrize("D,offset", [(13, 0), (36, 1), (64, 1), (112, 0)])
def test_flash_attention_f32_unaligned_rows_cuda(D, offset):
    """The float32 entry reads rows that are not 16-byte aligned (D not a
    multiple of 4, or a base one float off) 4 bytes at a time, D padded to
    the k-step in shared memory, within 1e-5 of the plain version."""
    dev = cuda_device()
    gen = torch.Generator(device=dev).manual_seed(D)
    B, S, Hq, Hkv = 2, 150, 4, 2
    n = [B * S * h * D for h in (Hq, Hkv, Hkv)]
    flat = torch.randn(offset + sum(n), device=dev, generator=gen)
    q, k, v = (flat[offset + a:offset + a + m].view(B, S, h, D) for a, m, h
               in ((0, n[0], Hq), (n[0], n[1], Hkv),
                   (n[0] + n[1], n[2], Hkv)))
    out = K8.flash_attention(q, k, v, window=40)
    ref = K8.flash_attention_plain(q, k, v, window=40)
    torch.cuda.synchronize()
    assert_close(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.requires_cuda
def test_flash_attention_f32_graph_replay_and_bits_cuda():
    """The float32 entry (3xTF32 on the tensor cores) captured in a CUDA
    graph replays the bits of an eager call, and repeated calls give equal
    bits."""
    dev = cuda_device()
    q, k, v = _t(*_qkv(1, 500, 500, 8, 8, 112, seed=4), device=dev)

    def fn():
        return K8.flash_attention(q, k, v)
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
@pytest.mark.parametrize("B,S,Hq,D", [(1, 500, 32, 112), (4, 2000, 32, 112),
                                      (2, 77, 2, 16)])
def test_flash_attention_f32_launch_plan_cuda(B, S, Hq, D):
    """The float32 entry's plan: one CTA of 8 warps per 128 query rows and
    (batch, head), shared memory for Q and a 2-stage ring of 64-key K and V
    tiles at a row stride of D padded to 8, plus 4."""
    cuda_device()
    info = K8.launch_info(B, S, Hq, D)
    assert info["threads"] == 256, info
    assert info["ctas"] == B * Hq * -(-S // 128), info
    assert info["smem_bytes"] == 4 * (-(-D // 8) * 8 + 4) * (128 + 256), info
    assert info["ctas_per_sm"] >= 1, info
