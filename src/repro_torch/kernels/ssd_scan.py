"""K9 — the Mamba-2 SSD chunked scan.

Replaces ``repro.kernels.ssd_scan.ssd_scan.ssd_scan_pallas``: take
(x [B, L, H, P], dt [B, L, H] post-softplus, A [H], Bm/Cm [B, L, N]
shared by all heads, chunk) and return (y [B, L, H, P] float32, h_final
[B, H, N, P] float32).  ``mamba_forward`` calls ``ssd_scan`` in every
Mamba layer of the dense-cache prefill.

On CUDA tensors ``ssd_scan`` launches ``csrc/ssd_scan.cu`` (one CTA per
(batch, head) walking the chunks with the state in shared memory; a
ragged last chunk is masked in the kernel as identity steps, dt = 0, so
nothing is padded or copied); on CPU tensors it runs ``ssd_scan_plain``,
the plain chunked scan ``repro_torch.models.ssm.ssd_chunked`` with one
group.  An initial state ``h0`` is taken as ``ssd_chunked`` takes it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, count_launch

_C = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_C] * 8 + [_I] * 6 + [_C]
_FN = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
MAX_CHUNK = 256
MAX_P = 128
MAX_N = 128
_TILE_ROWS = 32
SMEM_LIMIT = 232448                 # bytes of shared memory a CTA may use


def smem_bytes(chunk: int, P: int, N: int) -> int:
    """Shared memory of one CTA (float32 x, padded B, C, h, a 32-row tile
    of the attention form and four per-step vectors)."""
    Q = chunk
    return 4 * (Q * P + Q * (N + 1) + Q * N + N * P + _TILE_ROWS * Q
                + 4 * Q)


def _one_group(m: torch.Tensor, name: str) -> torch.Tensor:
    """[B, L, N] as it is, or [B, L, G, N] with G = 1 squeezed; the
    kernel shares B/C across all heads, so G > 1 is refused."""
    if m.dim() == 4:
        if m.shape[2] != 1:
            raise ValueError(f"ssd_scan: {name} has G={m.shape[2]} groups; "
                             f"the kernel takes G = 1 only")
        return m[:, :, 0]
    if m.dim() != 3:
        raise ValueError(f"ssd_scan: {name} must be [B, L, N] or "
                         f"[B, L, 1, N], got {tuple(m.shape)}")
    return m


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, chunk: int, *,
                   h0: torch.Tensor | None = None):
    """The plain version: ``ssd_chunked`` with one group (Bm/Cm
    [B, L, N])."""
    from repro_torch.models.ssm import ssd_chunked
    return ssd_chunked(x, dt, A, Bm[:, :, None], Cm[:, :, None], chunk,
                       h0)


def _launch(x, dt, A, Bm, Cm, chunk, h0):
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    dev = x.device
    if x.dtype not in _FN or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x/Bm/Cm must share float32 or bfloat16, "
                        f"got {x.dtype}/{Bm.dtype}/{Cm.dtype}")
    if dt.shape != (Bsz, L, H) or A.shape != (H,) \
            or Bm.shape != (Bsz, L, N) or Cm.shape != (Bsz, L, N):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)} disagree")
    if not (1 <= chunk <= MAX_CHUNK and 1 <= P <= MAX_P
            and 1 <= N <= MAX_N):
        raise ValueError(f"ssd_scan: chunk={chunk} (max {MAX_CHUNK}), P={P} "
                         f"(max {MAX_P}), N={N} (max {MAX_N}) outside the "
                         f"kernel's range")
    if smem_bytes(chunk, P, N) > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: chunk={chunk}, P={P}, N={N} need "
                         f"{smem_bytes(chunk, P, N)} B of shared memory "
                         f"(limit {SMEM_LIMIT})")
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm),
                    ("h0", h0)):
        if t is not None and t.device != dev:
            raise ValueError(f"ssd_scan: {name} on {t.device}, x on {dev}")
    x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    dt = dt.float().contiguous()
    A = A.float().contiguous()
    if h0 is not None:
        if h0.shape != (Bsz, H, N, P):
            raise ValueError(f"ssd_scan: h0 {tuple(h0.shape)} is not "
                             f"{(Bsz, H, N, P)}")
        h0 = h0.float().contiguous()
    y = torch.empty((Bsz, L, H, P), dtype=torch.float32, device=dev)
    h_out = torch.empty((Bsz, H, N, P), dtype=torch.float32, device=dev)
    if Bsz * H == 0 or L == 0:         # nothing to launch, nothing counted
        h_out.copy_(h0 if h0 is not None else torch.zeros_like(h_out))
        return y, h_out
    fn = _build.function(_FN[x.dtype], _ARGTYPES)
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
             Cm.data_ptr(), h0.data_ptr() if h0 is not None else None,
             y.data_ptr(), h_out.data_ptr(), Bsz, L, H, P, N, chunk,
             _build.current_stream(dev.index))
    _build.check(err, _FN[x.dtype])
    count_launch("ssd_scan")
    return y, h_out


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int, *,
             h0: torch.Tensor | None = None):
    """x [B, L, H, P]; dt [B, L, H]; A [H]; Bm/Cm [B, L, N] or
    [B, L, 1, N]; optional h0 [B, H, N, P].  Returns (y [B, L, H, P],
    h_final [B, H, N, P]), both float32."""
    Bm, Cm = _one_group(Bm, "Bm"), _one_group(Cm, "Cm")
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk, h0=h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    return _launch(x, dt, A, Bm, Cm, chunk, h0)
