"""The arithmetic of K9's float32 entry on the tensor cores, on the CPU.

``csrc/ssd_scan.cu`` runs the float32 SSD scan as the same four passes
as its bf16 entry (the dt * A cumsum and C.B^T per chunk, the chunk
states B^T . (w o x), the state passing over chunks, the chunk output
(C.B^T o decay o dt) . x + exp(cs) C.h_prev), with every product in
3xTF32 on ``mma.sync`` (``split_tf32`` in ``common.cuh``): each float32
operand is split into a big TF32 term, x rounded to nearest at 10
mantissa bits, and a small one, x - big, which the tensor cores read
truncated to TF32; a product a.b is small_a.big_b + big_a.small_b +
big_a.big_b summed in float32.  The operands w o x and the decayed C.B^T
are formed in float32 before they are split.  ``passes`` below emulates
that arithmetic in plain torch (a test helper, on no path): the products
of two TF32 terms are exact in float32, so float32 products of the terms
emulate the tensor cores up to the order of the float32 sums.

It is held within 1e-5 of the largest output against the JAX package's
Pallas kernel in interpret mode and its sequential recurrence (without
h0), the JAX chunked scan (with h0) and a float64 sequential recurrence,
at zamba2's and mamba2's state sizes, ragged last chunks included.  The
control: one TF32 term per operand (what a TF32 matmul does) misses 1e-4
(``SSD_TOL``, the limit the kernel keeps against its plain version on the
card), so the test can fail.

The kernels' shared memory is sized in the kernel source;
``smem_bytes`` below mirrors it, so the launch plan is checked here at
the edges of the range the wrapper takes (the card test holds the mirror
against ``ssd_scan.launch_info``).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from helpers.torch_parity import cap_threads, cuda_device
from repro_torch.kernels import ssd_scan as K9

cap_threads()

TOL = 1e-5           # of the reference's largest magnitude
SSD_TOL = 1e-4       # chip_smoke.py: the kernel against plain on the card
H, P, Q = 8, 64, 128
MAX_SMEM = 232448    # the dynamic shared memory an H100 CTA can have


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as the kernel rounds the big term: add half a
    TF32 ulp to the float32 bits and clear the low 13 (round to nearest,
    ties away from zero)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor cores read a TF32 operand: its low 13 bits
    ignored."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two TF32 terms of ``split_tf32``."""
    big = tf32(x)
    return big, trunc_tf32(x - big)


def product(eq: str, a: torch.Tensor, b: torch.Tensor,
            scheme: str) -> torch.Tensor:
    """einsum(eq, a, b) as the tensor cores compute it from the terms of
    ``scheme``: exact products of the terms, float32 sums."""
    if scheme == "3xtf32":
        (ab, as_), (bb, bs) = split(a), split(b)
        return (torch.einsum(eq, as_, bb) + torch.einsum(eq, ab, bs)
                + torch.einsum(eq, ab, bb))
    if scheme == "1xtf32":
        return torch.einsum(eq, tf32(a), tf32(b))
    raise ValueError(scheme)


def passes(x, dt, A, Bm, Cm, chunk, h0=None, scheme="3xtf32"):
    """The four passes of ``ssd_scan.cu``'s float32 entry.  x [B, L, H, P],
    dt [B, L, H], A [H], Bm/Cm [B, L, N], h0 [B, H, N, P] or None, all
    float32."""
    Bsz, L, Hh, Pd = x.shape
    N = Bm.shape[-1]
    nc = -(-L // chunk)
    pad = nc * chunk - L                 # identity steps: dt = 0, zeros
    x = F.pad(x, (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, chunk, Hh, Pd)
    dt = F.pad(dt, (0, 0, 0, pad)).reshape(Bsz, nc, chunk, Hh)
    Bq = F.pad(Bm, (0, 0, 0, pad)).reshape(Bsz, nc, chunk, N)
    Cq = F.pad(Cm, (0, 0, 0, pad)).reshape(Bsz, nc, chunk, N)
    # 1. prologue: cs per head, C.B^T once per chunk
    cs = torch.cumsum(dt * A, dim=2)                          # [B,nc,Q,H]
    cb = product("bcin,bcjn->bcij", Cq, Bq, scheme)
    # 2. chunk states: B^T . (w o x), w o x formed in float32
    w = torch.exp(cs[:, :, -1:] - cs) * dt
    states = product("bcjn,bcjhp->bchnp", Bq, w[..., None] * x, scheme)
    # 3. state passing (no product)
    h = torch.zeros(Bsz, Hh, N, Pd) if h0 is None else h0
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * torch.exp(cs[:, c, -1])[:, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                           # [B,nc,H,N,P]
    # 4. chunk output: C . h_prev, scaled by exp(cs); then att . x, att
    # formed in float32 where j <= i
    y = product("bcin,bchnp->bcihp", Cq, prev, scheme) \
        * torch.exp(cs)[..., None]
    csh = cs.permute(0, 1, 3, 2)                              # [B,nc,H,Q]
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    seg = torch.where(tri, csh[..., :, None] - csh[..., None, :], 0.0)
    att = torch.where(tri, cb[:, :, None] * torch.exp(seg), 0.0)
    att = att * dt.permute(0, 1, 3, 2)[:, :, :, None, :]
    y = y + product("bchij,bcjhp->bcihp", att, x, scheme)
    return y.reshape(Bsz, nc * chunk, Hh, Pd)[:, :L], h


def _inputs(L, N, seed, with_h0):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((1, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((1, L, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm = rng.standard_normal((1, L, N)).astype(np.float32)
    Cm = rng.standard_normal((1, L, N)).astype(np.float32)
    h0 = (rng.standard_normal((1, H, N, P)).astype(np.float32)
          if with_h0 else None)
    return x, dt, A, Bm, Cm, h0


def _sequential64(x, dt, A, Bm, Cm, h0):
    """The recurrence step by step in float64 (numpy)."""
    x, dt, A, Bm, Cm = (a.astype(np.float64) for a in (x, dt, A, Bm, Cm))
    h = (np.zeros((x.shape[0], x.shape[2], Bm.shape[-1], x.shape[3]))
         if h0 is None else h0.astype(np.float64))
    ys = []
    for t in range(x.shape[1]):
        h = h * np.exp(dt[:, t] * A)[..., None, None] + np.einsum(
            "bh,bn,bhp->bhnp", dt[:, t], Bm[:, t], x[:, t])
        ys.append(np.einsum("bn,bhnp->bhp", Cm[:, t], h))
    return np.stack(ys, axis=1), h


def _references(x, dt, A, Bm, Cm, h0):
    """(name, y, h) of each reference: without h0 the Pallas kernel in
    interpret mode and its sequential recurrence, with h0 the JAX chunked
    scan; the float64 recurrence in both cases."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    ja = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    refs = []
    if h0 is None:
        from repro.kernels.ssd_scan import ssd_scan, ssd_sequential_ref
        refs.append(("pallas_interpret",
                     *ssd_scan(*ja, chunk=Q, interpret=True)))
        refs.append(("sequential", *ssd_sequential_ref(*ja)))
    else:
        from repro.models.ssm import ssd_chunked
        refs.append(("jax_chunked", *ssd_chunked(
            ja[0], ja[1], ja[2], ja[3][:, :, None], ja[4][:, :, None], Q,
            jnp.asarray(h0))))
    refs.append(("sequential_f64", *_sequential64(x, dt, A, Bm, Cm, h0)))
    return [(n, np.asarray(y, np.float64), np.asarray(h, np.float64))
            for n, y, h in refs]


def _rel_err(got, want) -> float:
    return float(np.abs(got.numpy().astype(np.float64) - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("L", [1, 127, 128, 129, 300, 2000])
@pytest.mark.parametrize("N", [64, 128])
def test_3xtf32_passes_match_the_references(N, L, with_h0):
    """3xTF32 holds y and h_final within 1e-5 of each reference's largest
    magnitude (zamba2's N 64 and mamba2's N 128), ragged last chunks and
    an initial state included; at L 2000 (16 chunks, the last one 80
    steps) the error is carried through 15 steps of the state passing."""
    x, dt, A, Bm, Cm, h0 = _inputs(L, N, seed=L + N + 7, with_h0=with_h0)
    y, h = passes(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), Q,
                  None if h0 is None else torch.from_numpy(h0))
    assert y.shape == (1, L, H, P) and h.shape == (1, H, N, P)
    for name, yr, hr in _references(x, dt, A, Bm, Cm, h0):
        assert _rel_err(y, yr) < TOL, name
        assert _rel_err(h, hr) < TOL, name


@pytest.mark.parametrize("L,N", [(129, 64), (300, 128)])
def test_one_tf32_term_misses_the_tolerance(L, N):
    """The control: every operand rounded to one TF32 term misses 1e-4
    against the float64 recurrence, where 3xTF32 on the same inputs holds
    1e-5, so the test above can fail."""
    x, dt, A, Bm, Cm, _ = _inputs(L, N, seed=L + N + 7, with_h0=False)
    args = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    yr, hr = _sequential64(x, dt, A, Bm, Cm, None)
    y1, h1 = passes(*args, Q, scheme="1xtf32")
    assert max(_rel_err(y1, yr), _rel_err(h1, hr)) > SSD_TOL
    y3, h3 = passes(*args, Q)
    assert max(_rel_err(y3, yr), _rel_err(h3, hr)) < TOL


# =============================================================================
# the launch plan
# =============================================================================

def _pad(v: int, m: int) -> int:
    return -(-v // m) * m


def smem_bytes(dtype: torch.dtype, P_: int, N: int, chunk: int) -> list:
    """Dynamic shared memory of K9's four kernels (``ssd_scan.PASSES``
    order) as ``csrc/ssd_scan.cu`` sizes it: ``prologue_smem``,
    ``states_smem``, none for the state passing, ``output_smem``."""
    Qp = _pad(chunk, 16)
    if dtype == torch.bfloat16:
        def sb(c):                   # bf_stride: padded to 16, plus 8
            return _pad(c, 16) + 8
        return [2 * Qp * sb(N) * 2,
                Qp * sb(N) * 2 + 2 * Qp * sb(P_) * 2 + 4 * Qp, 0,
                Qp * (sb(N) + sb(P_)) * 2 + 2 * _pad(N, 16) * sb(P_) * 2
                + 12 * Qp]

    def sf(c):                       # f32_stride: padded to 8, plus 4
        return _pad(c, 8) + 4
    return [4 * Qp * sf(N), 4 * (64 * (sf(N) + sf(P_)) + Qp), 0,
            4 * ((Qp + _pad(N, 8)) * sf(P_) + 3 * Qp)]


EDGES = [(K9.MAX_CHUNK, K9.MAX_P, K9.MAX_N), (K9.MAX_CHUNK, 1, 1),
         (1, K9.MAX_P, K9.MAX_N), (241, 127, 121), (13, 5, 7),
         (128, 64, 64), (128, 64, 128)]


@pytest.mark.parametrize("chunk,P_,N", EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_in_range_plan_fits_shared_memory(dtype, chunk, P_, N):
    """Each kernel's shared memory at the edges of the range the wrapper
    takes (chunk 256, P 128, N 128; odd sizes padded; zamba2's and
    mamba2's shapes) fits an H100 CTA's 227 KB.  The float32 tiles take
    twice the bf16 ones' bytes: the chunk states stream 64 steps at a
    time and C's rows come from global memory, so at the widest shape the
    float32 chunk output needs 206 KB."""
    sizes = smem_bytes(dtype, P_, N, chunk)
    assert all(0 <= s <= MAX_SMEM for s in sizes), sizes
    if dtype == torch.float32 and (chunk, P_, N) == EDGES[0]:
        assert sizes == [135168, 68608, 0, 205824]
    if dtype == torch.float32 and (chunk, P_, N) == (128, 64, 64):
        assert sizes == [4 * 128 * 68, 4 * (64 * 136 + 128), 0,
                         4 * (192 * 68 + 384)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk,P_,N", EDGES)
def test_plan_mirror_matches_launch_info_cuda(dtype, chunk, P_, N):
    """``smem_bytes`` is what the kernel source plans (``launch_info``,
    which builds the kernels), at a ragged L; each kernel keeps at least
    one CTA per SM, and the workspace follows the shapes."""
    cuda_device()
    L = 2 * chunk + 3
    info = K9.launch_info(2, L, 3, P_, N, chunk, dtype)
    assert [k["smem_bytes"] for k in info["kernels"]] == smem_bytes(
        dtype, P_, N, chunk)
    assert all(k["ctas_per_sm"] >= 1 for k in info["kernels"]), info
    Qp, nc = _pad(chunk, 16), -(-L // chunk)
    assert K9.workspace_elems(2, L, 3, P_, N, chunk) == [
        2 * nc * 3 * Qp, 2 * nc * Qp * Qp, 2 * nc * 3 * N * P_]
