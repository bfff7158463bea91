"""The port's Mamba-2 block and kernel K9 (``kernels.ssd_scan``) against
the JAX package, in float32 on the same numpy inputs.

K9's plain version (what the wrapper runs on CPU tensors) is held against
the Pallas kernel in interpret mode, its chunked oracle and the
sequential recurrence, on the shapes of ``tests/test_kernels.py`` and its
ragged L = 37 case; ``mamba_forward`` and ``mamba_decode_step`` against
JAX's with weights carried over.  Floats within ``ATOL``/``RTOL`` of
``helpers.torch_parity`` (XLA and torch sum in other orders) except where
a test states its own limit.  The ``requires_cuda`` cases hold the CUDA
kernel against the plain version on the card and skip here.

JAX is imported inside the tests that use it, so the CUDA cases also
collect on a machine that has only torch.
"""
import numpy as np
import pytest
import torch

from helpers.torch_parity import (ATOL, RTOL, assert_close, cap_threads,
                                  cuda_device)
from repro_torch import kernels
from repro_torch.configs.base import registry, smoke
from repro_torch.kernels import ssd_scan as K9
from repro_torch.launch import longctx_decode
from repro_torch.models import ssm
from repro_torch.models import transformer as T

cap_threads()

SHAPES = [(2, 64, 4, 8, 16, 16), (1, 128, 8, 16, 32, 32),
          (2, 48, 2, 8, 8, 16)]


def _jax():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _scan_inputs(B, L, H, P, N, seed, a_scale=0.5):
    """x, dt (post-softplus), A (negative), Bm/Cm [B, L, N] as numpy."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * a_scale)).astype(np.float32)
    Bm = rng.standard_normal((B, L, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.asarray(a)).to(device) for a in arrays]


@pytest.mark.parametrize("B,L,H,P,N,chunk", SHAPES)
def test_ssd_scan_plain_vs_pallas_and_refs(B, L, H, P, N, chunk):
    """The wrapper on CPU tensors (the plain version) against the Pallas
    kernel in interpret mode and its chunked oracle (atol = rtol = 1e-4,
    the limit ``test_kernels.py`` holds between those two), and against
    the sequential recurrence (1e-3, likewise)."""
    _jax()
    import jax.numpy as jnp
    from repro.kernels.ssd_scan import (ssd_scan, ssd_scan_ref,
                                        ssd_sequential_ref)
    arrs = _scan_inputs(B, L, H, P, N, seed=2)
    y, h = K9.ssd_scan(*_t(*arrs), chunk)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (B, L, H, P) and h.shape == (B, H, N, P)
    ja = [jnp.asarray(a) for a in arrs]
    yp, hp = ssd_scan(*ja, chunk=chunk, interpret=True)
    assert_close(y, yp, atol=1e-4, rtol=1e-4)
    assert_close(h, hp, atol=1e-4, rtol=1e-4)
    yr, hr = ssd_scan_ref(*ja, chunk)
    assert_close(y, yr, atol=1e-4, rtol=1e-4)
    assert_close(h, hr, atol=1e-4, rtol=1e-4)
    ys, hs = ssd_sequential_ref(*ja)
    assert_close(y, ys, atol=1e-3, rtol=1e-3)
    assert_close(h, hs, atol=1e-3, rtol=1e-3)


def test_ssd_scan_padding():
    """A ragged L = 37 against chunk 16: the last chunk's identity steps
    leave y and h_final as the sequential recurrence gives them."""
    _jax()
    import jax.numpy as jnp
    from repro.kernels.ssd_scan import ssd_scan, ssd_sequential_ref
    arrs = _scan_inputs(1, 37, 2, 8, 8, seed=3, a_scale=1.0)
    y, h = K9.ssd_scan(*_t(*arrs), 16)
    ja = [jnp.asarray(a) for a in arrs]
    ys, hs = ssd_sequential_ref(*ja)
    assert_close(y, ys, atol=1e-3, rtol=1e-3)
    assert_close(h, hs, atol=1e-3, rtol=1e-3)
    yp, hp = ssd_scan(*ja, chunk=16, interpret=True)
    assert_close(y, yp, atol=1e-4, rtol=1e-4)
    assert_close(h, hp, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("G,with_h0", [(1, True), (2, False), (2, True)])
def test_ssd_chunked_groups_and_h0_match_jax(G, with_h0):
    """``ssd_chunked`` with B/C groups and an initial state against the
    JAX function (both float32, the same algorithm)."""
    _jax()
    import jax.numpy as jnp
    from repro.models import ssm as jssm
    B, L, H, P, N, Q = 2, 21, 4, 8, 6, 8
    rng = np.random.RandomState(4)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    h0 = (rng.standard_normal((B, H, N, P)).astype(np.float32)
          if with_h0 else None)
    y, h = ssm.ssd_chunked(*_t(x, dt, A, Bm, Cm), Q,
                           None if h0 is None else torch.from_numpy(h0))
    jy, jh = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                              Q, None if h0 is None else jnp.asarray(h0))
    assert_close(y, jy)
    assert_close(h, jh)


# The first computation of a fresh process on two intra-op threads, as in
# the test worker where ROADMAP C10 showed: the plain scan's exponentials
# were the process's first parallel call into MKL's vector math, whose
# set-up by two threads at once left one thread's half of the call far
# off float32 rounding.
_FRESH_SCAN = r"""
import numpy as np
import torch
torch.set_num_threads(2)
import repro_torch
from repro_torch.models.ssm import ssd_chunked
rng = np.random.RandomState(2)
x = rng.standard_normal((2, 64, 4, 8)).astype(np.float32)
dt = np.log1p(np.exp(rng.standard_normal((2, 64, 4)))).astype(np.float32)
A = (-np.exp(rng.standard_normal(4) * 0.5)).astype(np.float32)
Bm = rng.standard_normal((2, 64, 16)).astype(np.float32)
Cm = rng.standard_normal((2, 64, 16)).astype(np.float32)
y, _ = ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A)),
                   torch.from_numpy(Bm)[:, :, None],
                   torch.from_numpy(Cm)[:, :, None], 16)
h = np.zeros((2, 4, 16, 8))
want = []
for t in range(64):
    h = h * np.exp(dt[:, t] * A.astype(np.float64))[..., None, None] \
        + np.einsum("bh,bn,bhp->bhnp", dt[:, t], Bm[:, t], x[:, t])
    want.append(np.einsum("bn,bhnp->bhp", Cm[:, t], h))
want = np.stack(want, axis=1)
excess = np.abs(y.numpy() - want) / (1e-4 * (1 + np.abs(want)))
print(float(excess.max()))
"""


def test_plain_scan_first_call_in_fresh_processes():
    """ROADMAP C10: ``ssd_chunked`` as the first computation of a fresh
    process on two intra-op threads (importing ``repro_torch`` sets up
    MKL's vector math from one thread first), in 32 processes, 8 at a
    time: y within 1e-4 of a float64 recurrence in every one.  With the
    repair undone this test failed in 3 of 4 runs."""
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]))
    excess = []
    for _ in range(4):
        procs = [subprocess.Popen([sys.executable, "-c", _FRESH_SCAN],
                                  env=env, stdout=subprocess.PIPE, text=True)
                 for _ in range(8)]
        for p in procs:
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0
            excess.append(float(out.split()[-1]))
    assert max(excess) < 1, excess


def test_ssd_scan_refuses_groups():
    """K9 shares B/C across all heads, as the Pallas kernel does: more
    than one group is refused before any device choice."""
    x, dt, A, Bm, Cm = _t(*_scan_inputs(1, 8, 2, 4, 4, seed=0))
    y, _ = K9.ssd_scan(x, dt, A, Bm[:, :, None], Cm[:, :, None], 4)
    assert_close(y, K9.ssd_scan(x, dt, A, Bm, Cm, 4)[0], atol=0, rtol=0)
    two = torch.stack([Bm, Bm], dim=2)
    with pytest.raises(ValueError, match="G = 1"):
        K9.ssd_scan(x, dt, A, two, two, 4)


def _spec_and_params(seed=0, **kw):
    """A small spec and the JAX block's weights (numpy), with dt_bias,
    A_log, D, conv_b and norm randomised so every term is exercised."""
    jax, jnp = _jax()
    from repro.models import ssm as jssm
    spec = jssm.make_spec(32, headdim=8, d_state=8, chunk=8, **kw)
    jp = jssm.init_mamba_params(jax.random.PRNGKey(seed), spec)
    rng = np.random.RandomState(seed + 10)
    jp = jp._replace(
        dt_bias=jnp.asarray(rng.uniform(-5, -1, spec.n_heads), jnp.float32),
        A_log=jnp.asarray(rng.uniform(-1, 1, spec.n_heads), jnp.float32),
        D=jnp.asarray(rng.uniform(0.5, 1.5, spec.n_heads), jnp.float32),
        conv_b=jnp.asarray(rng.standard_normal(spec.conv_ch) * 0.1,
                           jnp.float32),
        norm=jnp.asarray(rng.uniform(0.5, 1.5, spec.d_inner), jnp.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in
          jp._asdict().items()}
    tspec = ssm.make_spec(32, headdim=8, d_state=8, chunk=8, **kw)
    return spec, jp, tspec, tp


def test_make_spec_and_init_scales_match_jax():
    """The same spec fields, leaf names, shapes and constant leaves as the
    JAX init; the random leaves have the JAX scales."""
    jax, _ = _jax()
    from repro.models import ssm as jssm
    for kw in ({}, {"expand": 2, "headdim": 64, "d_state": 64}):
        assert tuple(ssm.make_spec(256, **kw)) == tuple(
            jssm.make_spec(256, **kw))
        assert ssm.make_spec(256, **kw).conv_ch == \
            jssm.make_spec(256, **kw).conv_ch
    spec = ssm.make_spec(256, headdim=32, d_state=16)
    gen = torch.Generator().manual_seed(0)
    p = ssm.init_mamba_params(spec, gen)
    jp = jssm.init_mamba_params(jax.random.PRNGKey(0),
                                jssm.make_spec(256, headdim=32, d_state=16))
    assert list(p) == list(jp._fields)
    for k, v in jp._asdict().items():
        assert tuple(p[k].shape) == v.shape, k
    for k in ("conv_b", "dt_bias", "A_log", "D", "norm"):
        assert_close(p[k], jp._asdict()[k], atol=0, rtol=0)
    for k, std in (("in_proj_x", 256 ** -0.5), ("conv_w", 0.1),
                   ("out_proj", spec.d_inner ** -0.5)):
        assert abs(float(p[k].std()) / std - 1) < 0.05, k


def test_causal_depthwise_conv_matches_jax():
    _, jnp = _jax()
    from repro.models import ssm as jssm
    rng = np.random.RandomState(5)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    assert_close(ssm._causal_depthwise_conv(*_t(x, w, b)),
                 jssm._causal_depthwise_conv(*(jnp.asarray(a)
                                               for a in (x, w, b))))


@pytest.mark.parametrize("L,with_state", [(13, False), (2, False),
                                          (13, True)])
def test_mamba_forward_return_state_matches_jax(L, with_state):
    """The block's output, final SSM state and raw conv context, from a
    zero state and from a carried one (h0, conv0)."""
    _, jnp = _jax()
    from repro.models import ssm as jssm
    spec, jp, tspec, tp = _spec_and_params(1)
    rng = np.random.RandomState(6)
    x = rng.standard_normal((2, L, 32)).astype(np.float32)
    kw, tkw = {}, {}
    if with_state:
        h0 = rng.standard_normal((2, spec.n_heads, spec.d_state,
                                  spec.headdim)).astype(np.float32)
        c0 = rng.standard_normal((2, spec.d_conv - 1,
                                  spec.conv_ch)).astype(np.float32)
        kw = {"h0": jnp.asarray(h0), "conv0": jnp.asarray(c0)}
        tkw = {"h0": torch.from_numpy(h0), "conv0": torch.from_numpy(c0)}
    out, (h, tail) = ssm.mamba_forward(tp, tspec, torch.from_numpy(x),
                                       return_state=True, **tkw)
    jout, (jh, jtail) = jssm.mamba_forward(jp, spec, jnp.asarray(x),
                                           return_state=True, **kw)
    assert_close(out, jout)
    assert_close(h, jh)
    assert_close(tail, jtail)
    assert_close(ssm.mamba_forward(tp, tspec, torch.from_numpy(x), **tkw),
                 jout)


def test_mamba_decode_step_matches_jax():
    """Three decode steps from a random state: output, h and the rolling
    conv context."""
    _, jnp = _jax()
    from repro.models import ssm as jssm
    spec, jp, tspec, tp = _spec_and_params(2)
    rng = np.random.RandomState(7)
    h = rng.standard_normal((3, spec.n_heads, spec.d_state,
                             spec.headdim)).astype(np.float32)
    conv = rng.standard_normal((3, spec.d_conv - 1,
                                spec.conv_ch)).astype(np.float32)
    th, tc = torch.from_numpy(h), torch.from_numpy(conv)
    jh, jc = jnp.asarray(h), jnp.asarray(conv)
    for _ in range(3):
        x = rng.standard_normal((3, 1, 32)).astype(np.float32)
        out, th, tc = ssm.mamba_decode_step(tp, tspec, torch.from_numpy(x),
                                            th, tc)
        jout, jh, jc = jssm.mamba_decode_step(jp, spec, jnp.asarray(x), jh,
                                              jc)
        assert_close(out, jout)
        assert_close(th, jh)
        assert_close(tc, jc)


def test_decode_continues_the_scan():
    """Within the port: ``mamba_forward`` over L + 3 tokens equals
    ``mamba_forward`` over L then three decode steps (the chunked scan
    and the O(1) recurrence describe one model)."""
    _, _, tspec, tp = _spec_and_params(3)
    x = torch.from_numpy(np.random.RandomState(8).standard_normal(
        (2, 14, 32)).astype(np.float32))
    full = ssm.mamba_forward(tp, tspec, x)
    out, (h, tail) = ssm.mamba_forward(tp, tspec, x[:, :11],
                                       return_state=True)
    for t in range(11, 14):
        o, h, tail = ssm.mamba_decode_step(tp, tspec, x[:, t:t + 1], h, tail)
        assert_close(o[:, 0], full[:, t], atol=10 * ATOL, rtol=RTOL)


# =============================================================================
# the CUDA kernel on the card
# =============================================================================

# the card cases: the first five since the kernel was written, then
# L around one chunk, the widest tiles (P = N = 128, chunk 256), odd sizes
# (scalar loads, padded tiles), zamba2's and mamba2's full prefill
# shapes, and the float32 long-context probe's (zamba2's heads, one
# 500-token prompt)
KERNEL_SHAPES = [
    (2, 64, 4, 8, 16, 16, False), (1, 37, 2, 8, 8, 16, True),
    (2, 300, 6, 64, 64, 128, False), (1, 200, 4, 64, 128, 128, True),
    (1, 45, 3, 16, 16, 8, False),
    (2, 1, 8, 64, 64, 128, True), (2, 127, 8, 64, 64, 128, False),
    (2, 128, 8, 64, 128, 128, True), (2, 129, 8, 64, 128, 128, False),
    (1, 300, 4, 128, 128, 256, True), (1, 50, 3, 5, 7, 13, True),
    (4, 2000, 112, 64, 64, 128, False), (4, 2000, 64, 64, 128, 128, False),
    (1, 500, 112, 64, 64, 128, True)]


def _card_inputs(B, L, H, P, N, dtype, seed=9, with_h0=False):
    dev = cuda_device()
    x, dt, A, Bm, Cm = _t(*_scan_inputs(B, L, H, P, N, seed=seed),
                          device=dev)
    h0 = None
    if with_h0:
        h0 = torch.from_numpy(np.random.RandomState(seed + 1).standard_normal(
            (B, H, N, P)).astype(np.float32)).to(dev)
    return x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype), h0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,P,N,chunk,with_h0", KERNEL_SHAPES)
def test_ssd_scan_kernel_vs_plain_cuda(dtype, B, L, H, P, N, chunk,
                                       with_h0):
    """K9 against its plain version on the same card inputs, ragged last
    chunks and an initial state included.  float32: float32-accurate
    products in both (3xTF32 on the kernel's tensor cores, FMA in plain),
    summed in other orders over up to L terms; bf16: the kernel's
    tensor-core products hold each float32 operand to 2**-17 in two bf16
    terms.
    Either way the error scales with the largest magnitude of the output
    (|y| reaches ~300 at L = 300): atol is 1e-4 of that magnitude, rtol
    1e-4."""
    x, dt, A, Bm, Cm, h0 = _card_inputs(B, L, H, P, N, dtype,
                                        with_h0=with_h0)
    before = kernels.launch_counts()["ssd_scan"]
    y, h = K9.ssd_scan(x, dt, A, Bm, Cm, chunk, h0=h0)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ssd_scan"] == before + 1
    yp, hp = K9.ssd_scan_plain(x, dt, A, Bm, Cm, chunk, h0=h0)
    for got, want in ((y, yp), (h, hp)):
        assert_close(got, want, atol=1e-4 * float(want.abs().max()),
                     rtol=1e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_bits_cuda(dtype):
    """Two calls give the same bits, and each sequence of a batch of 4
    (with its initial state) gives the bits it gives alone: the split of
    the work depends on (L, H, P, N, chunk) only."""
    x, dt, A, Bm, Cm, h0 = _card_inputs(4, 300, 8, 64, 64, dtype,
                                        with_h0=True)
    y, h = K9.ssd_scan(x, dt, A, Bm, Cm, 128, h0=h0)
    y2, h2 = K9.ssd_scan(x, dt, A, Bm, Cm, 128, h0=h0)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    for b in range(4):
        one = slice(b, b + 1)
        yb, hb = K9.ssd_scan(x[one], dt[one], A, Bm[one], Cm[one], 128,
                             h0=h0[one])
        assert torch.equal(yb, y[one]) and torch.equal(hb, h[one]), b


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_graph_cuda(dtype):
    """One call captured in a CUDA graph replays to the eager call's bits
    (the workspace comes from the graph's pool, no launch makes an API
    call); the launch count moves by one per eager call."""
    x, dt, A, Bm, Cm, h0 = _card_inputs(2, 300, 8, 64, 64, dtype,
                                        with_h0=True)
    before = kernels.launch_counts()["ssd_scan"]
    y, h = K9.ssd_scan(x, dt, A, Bm, Cm, 128, h0=h0)
    assert kernels.launch_counts()["ssd_scan"] == before + 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K9.ssd_scan(x, dt, A, Bm, Cm, 128, h0=h0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        yg, hg = K9.ssd_scan(x, dt, A, Bm, Cm, 128, h0=h0)
    yg.zero_()
    hg.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(yg, y) and torch.equal(hg, h)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,P,N,chunk", [
    (4, 2000, 112, 64, 64, 128), (4, 2000, 64, 64, 128, 128),
    (1, 300, 4, 128, 128, 256), (1, 50, 3, 5, 7, 13)])
def test_ssd_scan_launch_info_cuda(dtype, B, L, H, P, N, chunk):
    """``launch_info`` reports the four kernels a call launches, with
    grids that follow the shapes (a CTA per chunk, per (chunk, head),
    per 1024 state elements of a head, per (chunk, head)), shared memory
    within the card's 227 KB, at least one CTA resident per SM, and the
    workspace of cs, C.B^T and the chunk states."""
    cuda_device()
    info = K9.launch_info(B, L, H, P, N, chunk, dtype)
    nc = -(-L // chunk)
    assert [k["name"] for k in info["kernels"]] == list(K9.PASSES)
    assert [k["ctas"] for k in info["kernels"]] == [
        nc * B, nc * H * B, -(-(N * P) // 1024) * H * B, nc * H * B]
    for k in info["kernels"]:
        assert 0 <= k["smem_bytes"] <= 227 * 1024, k
        assert k["ctas_per_sm"] >= 1, k
    Qp = -(-chunk // 16) * 16
    assert info["workspace_bytes"] == 4 * B * nc * (H * Qp + Qp * Qp
                                                    + H * N * P)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("H,N", [(112, 64), (64, 128)])
def test_ssd_scan_f32_bits_across_batch_cuda(H, N):
    """At zamba2's and mamba2's float32 prefill shapes (B 4, L 2000, with
    an initial state) each sequence gives alone the bits it gives in the
    batch: the float32 entry's split depends on (L, H, P, N, chunk)
    only."""
    x, dt, A, Bm, Cm, h0 = _card_inputs(4, 2000, H, 64, N, torch.float32,
                                        seed=11, with_h0=True)
    y, h = K9.ssd_scan(x, dt, A, Bm, Cm, 128, h0=h0)
    for b in range(4):
        one = slice(b, b + 1)
        yb, hb = K9.ssd_scan(x[one], dt[one], A, Bm[one], Cm[one], 128,
                             h0=h0[one])
        assert torch.equal(yb, y[one]) and torch.equal(hb, h[one]), b


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,P,N,chunk,with_h0", [
    (1, 257, 2, 128, 128, 256, True), (1, 513, 2, 128, 128, 256, False),
    (2, 3, 2, 1, 1, 1, True), (1, 300, 3, 127, 121, 241, True),
    (1, 17, 2, 128, 128, 16, False), (1, 40, 2, 128, 1, 256, True)])
def test_ssd_scan_range_edges_cuda(dtype, B, L, H, P, N, chunk, with_h0):
    """The edges of the range the wrapper takes launch and agree with the
    plain version within 1e-4 of the largest output: chunk 256 with
    P = N = 128 and ragged L (the widest tiles; the float32 chunk output
    plans 206 KB of shared memory), chunk 1 with P = N = 1, odd sizes
    padded to the k-steps, and a chunk longer than L."""
    x, dt, A, Bm, Cm, h0 = _card_inputs(B, L, H, P, N, dtype, seed=13,
                                        with_h0=with_h0)
    y, h = K9.ssd_scan(x, dt, A, Bm, Cm, chunk, h0=h0)
    torch.cuda.synchronize()
    yp, hp = K9.ssd_scan_plain(x, dt, A, Bm, Cm, chunk, h0=h0)
    for got, want in ((y, yp), (h, hp)):
        assert_close(got, want, atol=1e-4 * float(want.abs().max()),
                     rtol=1e-4)


@pytest.mark.requires_cuda
def test_ssd_scan_kernel_empty_sequence_cuda():
    """L = 0: no launch, h_final is the initial state."""
    dev = cuda_device()
    x, dt, A, Bm, Cm = _t(*_scan_inputs(1, 0, 2, 8, 8, seed=0), device=dev)
    h0 = torch.randn((1, 2, 8, 8), device=dev)
    before = kernels.launch_counts()["ssd_scan"]
    y, h = K9.ssd_scan(x, dt, A, Bm, Cm, 8, h0=h0)
    assert y.shape == (1, 0, 2, 8) and torch.equal(h, h0)
    assert kernels.launch_counts()["ssd_scan"] == before


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["mamba2_1_3b", "zamba2_7b"])
def test_generate_on_the_card_matches_the_cpu_cuda(name):
    """Smoke width in float32: prefill on the kernels (K9 every layer, K8
    at each shared site) and 5 decode steps on the card against the plain
    versions on the CPU, from the same weights."""
    dev = cuda_device()
    cfg = smoke(registry()[name])
    params = T.init_params(cfg, seed=0, device="cpu")
    card = _to(params, dev)
    prompts = np.random.RandomState(7).randint(0, cfg.vocab,
                                               size=(2, 37)).tolist()
    kernels.reset_launch_counts()
    got = longctx_decode.generate(card, cfg, prompts, 5, 48)
    n = kernels.launch_counts()
    assert n["ssd_scan"] == cfg.n_layers
    assert n["flash_attention"] == (cfg.n_layers // cfg.shared_attn_every
                                    if cfg.layout == "hybrid" else 0)
    want = longctx_decode.generate(params, cfg, prompts, 5, 48)
    assert got["tokens"] == want["tokens"]
    assert_close(got["logits"], want["logits"], atol=1e-4, rtol=1e-4)
    assert_close(got["first_logits"], want["first_logits"], atol=1e-4,
                 rtol=1e-4)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)
