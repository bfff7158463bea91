"""The arithmetic of kernel K9's chunk-parallel passes, on the CPU.

``csrc/ssd_scan.cu`` runs the SSD scan as four passes over chunks: the
dt * A cumsum and C.B^T per chunk, the chunk states B^T . (w o x), the
state passing over chunks, and the chunk output (C.B^T o decay o dt) . x
+ exp(cs) C.h_prev.  Its bf16 entry runs the products on the tensor
cores, where bf16 x bf16 products are exact and sums are float32, and
splits the float32 operand of three products (w o x, h_prev, the decayed
C.B^T) into ``TERMS`` bf16 terms.  ``passes`` below emulates that
arithmetic in plain torch (a test helper, on no path): every product has
operands that are exact in bf16 and float32 sums.  It is held against
the JAX package's Pallas kernel in interpret mode and its sequential
recurrence (without h0), and against the JAX chunked scan and a float64
sequential recurrence (with h0), within 1e-4 of the largest output, at
zamba2-like narrow shapes with inputs exact in bf16.  One term (the
float32 operand rounded to bf16) must miss that, so the test can fail.

The wrapper's refusals (G > 1, chunk/P/N outside the kernel's range) are
checked here too: they hold on every device.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from helpers.torch_parity import cap_threads, cuda_device
from repro_torch.kernels import ssd_scan as K9

cap_threads()

TERMS = 2            # bf16 terms per float32 operand, as in ssd_scan.cu
TOL = 1e-4           # of the reference's largest magnitude (SSD_TOL)
H, P, Q = 8, 64, 128


def _split(t: torch.Tensor, k: int) -> list[torch.Tensor]:
    """t as k bf16 terms: hi = bf16(t), then bf16 of each remainder."""
    out = []
    for _ in range(k):
        hi = t.to(torch.bfloat16).float()
        out.append(hi)
        t = t - hi
    return out


def passes(x, dt, A, Bm, Cm, chunk, h0=None, terms=TERMS):
    """The four passes of ``ssd_scan.cu``'s bf16 entry, in float32 with
    bf16-exact operands.  x [B, L, H, P], dt [B, L, H], A [H], Bm/Cm
    [B, L, N] (exact in bf16), h0 [B, H, N, P] or None."""
    Bsz, L, Hh, Pd = x.shape
    N = Bm.shape[-1]
    nc = -(-L // chunk)
    pad = nc * chunk - L                 # identity steps: dt = 0, zeros
    x = F.pad(x, (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, chunk, Hh, Pd)
    dt = F.pad(dt, (0, 0, 0, pad)).reshape(Bsz, nc, chunk, Hh)
    Bq = F.pad(Bm, (0, 0, 0, pad)).reshape(Bsz, nc, chunk, N)
    Cq = F.pad(Cm, (0, 0, 0, pad)).reshape(Bsz, nc, chunk, N)
    # 1. prologue: cs per head, C.B^T once per chunk (bf16 operands)
    cs = torch.cumsum(dt * A, dim=2)                          # [B,nc,Q,H]
    cb = torch.einsum("bcin,bcjn->bcij", Cq, Bq)
    # 2. chunk states: B^T . (w o x), w o x in bf16 terms
    w = torch.exp(cs[:, :, -1:] - cs) * dt
    states = sum(torch.einsum("bcjn,bcjhp->bchnp", Bq, t)
                 for t in _split(w[..., None] * x, terms))
    # 3. state passing
    h = torch.zeros(Bsz, Hh, N, Pd) if h0 is None else h0
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * torch.exp(cs[:, c, -1])[:, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                           # [B,nc,H,N,P]
    # 4. chunk output: C . h_prev (h_prev in terms), then att . x (att in
    # terms), exp() only where j <= i
    y = sum(torch.einsum("bcin,bchnp->bcihp", Cq, t)
            for t in _split(prev, terms)) * torch.exp(cs)[..., None]
    csh = cs.permute(0, 1, 3, 2)                              # [B,nc,H,Q]
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    seg = torch.where(tri, csh[..., :, None] - csh[..., None, :], 0.0)
    att = torch.where(tri, cb[:, :, None] * torch.exp(seg), 0.0)
    att = att * dt.permute(0, 1, 3, 2)[:, :, :, None, :]
    y = y + sum(torch.einsum("bchij,bcjhp->bcihp", t, x)
                for t in _split(att, terms))
    return y.reshape(Bsz, nc * chunk, Hh, Pd)[:, :L], h


def _inputs(L, N, seed, with_h0):
    """Seeded inputs, x/B/C exact in bf16 (what the bf16 entry reads)."""
    rng = np.random.RandomState(seed)

    def bf(a):
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy()

    x = bf(rng.standard_normal((1, L, H, P)).astype(np.float32))
    dt = np.log1p(np.exp(rng.standard_normal((1, L, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm = bf(rng.standard_normal((1, L, N)).astype(np.float32))
    Cm = bf(rng.standard_normal((1, L, N)).astype(np.float32))
    h0 = (rng.standard_normal((1, H, N, P)).astype(np.float32)
          if with_h0 else None)
    return x, dt, A, Bm, Cm, h0


def _sequential64(x, dt, A, Bm, Cm, h0):
    """The recurrence step by step in float64 (numpy)."""
    x, dt, A, Bm, Cm = (a.astype(np.float64) for a in (x, dt, A, Bm, Cm))
    h = (np.zeros((x.shape[0], H, Bm.shape[-1], P)) if h0 is None
         else h0.astype(np.float64))
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
def test_passes_match_the_references(N, L, with_h0):
    """Two bf16 terms hold y and h_final within 1e-4 of each reference's
    largest magnitude, ragged last chunks and an initial state included;
    at zamba2's prompt length (16 chunks, the last one 80 steps) the
    error is carried through 15 steps of the state passing."""
    x, dt, A, Bm, Cm, h0 = _inputs(L, N, seed=L + N, with_h0=with_h0)
    y, h = passes(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), Q,
                  None if h0 is None else torch.from_numpy(h0))
    assert y.shape == (1, L, H, P) and h.shape == (1, H, N, P)
    for name, yr, hr in _references(x, dt, A, Bm, Cm, h0):
        assert _rel_err(y, yr) < TOL, name
        assert _rel_err(h, hr) < TOL, name


@pytest.mark.parametrize("L,N", [(129, 64), (300, 128)])
def test_one_term_misses_the_tolerance(L, N):
    """The control: the float32 operands rounded to one bf16 term miss
    1e-4 against the float64 recurrence, so the test above can fail."""
    x, dt, A, Bm, Cm, _ = _inputs(L, N, seed=L + N, with_h0=False)
    args = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    yr, hr = _sequential64(x, dt, A, Bm, Cm, None)
    y1, h1 = passes(*args, Q, terms=1)
    assert max(_rel_err(y1, yr), _rel_err(h1, hr)) > TOL
    y2, h2 = passes(*args, Q)
    assert max(_rel_err(y2, yr), _rel_err(h2, hr)) < TOL


@pytest.mark.parametrize("chunk,P_,N", [(0, 8, 8), (257, 8, 8),
                                        (16, 129, 8), (16, 8, 129)])
def test_ssd_scan_refuses_out_of_range(chunk, P_, N):
    """chunk, P and N outside the kernel's range are refused before any
    device choice (CPU tensors here), as G > 1 is."""
    x = torch.zeros(1, 4, 2, P_)
    dt = torch.zeros(1, 4, 2)
    A = -torch.ones(2)
    Bm = torch.zeros(1, 4, N)
    with pytest.raises(ValueError, match="range"):
        K9.ssd_scan(x, dt, A, Bm, Bm, chunk)
    two = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="G = 1"):
        K9.ssd_scan(torch.zeros(1, 4, 2, 8), dt, A, two, two, 16)


@pytest.mark.requires_cuda
def test_workspace_bytes_follow_the_shapes():
    """The kernel source sizes the workspace (``workspace_elems``, which
    builds the kernels): cs [B, nc, H, Qp], C.B^T [B, nc, Qp, Qp] and the
    chunk states [B, nc, H, N, P], float32, with Qp the chunk rounded up
    to 16: 125 MB at zamba2's prefill shape, 141 MB at mamba2's."""
    cuda_device()
    B, L, Hh, Pd, N = 4, 2000, 112, 64, 64
    nc, Qp = 16, 128
    assert K9.workspace_elems(B, L, Hh, Pd, N, 128) == [
        B * nc * Hh * Qp, B * nc * Qp * Qp, B * nc * Hh * N * Pd]
    assert K9.workspace_elems(1, 37, 2, 8, 8, 13) == [
        3 * 2 * 16, 3 * 16 * 16, 3 * 2 * 8 * 8]
    mb = 4 * sum(K9.workspace_elems(B, L, Hh, Pd, N, 128)) / 1e6
    assert round(mb) == 125
    assert round(4 * sum(K9.workspace_elems(B, L, 64, Pd, 128, 128))
                 / 1e6) == 141
