"""K9 — the Mamba-2 SSD chunked scan.

Replaces ``repro.kernels.ssd_scan.ssd_scan.ssd_scan_pallas``: take
(x [B, L, H, P], dt [B, L, H] post-softplus, A [H], Bm/Cm [B, L, N]
shared by all heads, chunk) and return (y [B, L, H, P] float32, h_final
[B, H, N, P] float32).  ``mamba_forward`` calls ``ssd_scan`` in every
Mamba layer of the dense-cache prefill.

On CUDA tensors ``ssd_scan`` launches ``csrc/ssd_scan.cu``: four kernels,
each parallel over chunks (a prologue per chunk with the dt * A cumsum of
every head and C.B^T shared by all heads; the chunk states per (chunk,
head); the state passing over chunks per state element; the chunk
output per (chunk, head)), all products on the tensor cores: the bf16
entry's with each float32 operand split into two bf16 terms, the float32
entry's in 3xTF32 (each float32 operand split into two TF32 terms, three
products summed in float32).  A ragged last chunk is masked in the kernels
as identity steps (dt = 0), so nothing is padded or copied.  The wrapper
allocates the kernels' float32 workspace from torch's caching allocator,
in the sizes the kernel source reports (``workspace_elems``: cs
[B, nc, H, Qp], C.B^T [B, nc, Qp, Qp], the chunk states
[B, nc, H, N, P]; 125 MB at zamba2's prefill shape), so a call
allocates nothing else, makes no host sync, and can be captured in a
CUDA graph.  Its least work moves x, B, C, dt, y and
h_final once (~357 MB at zamba2's shape, 0.107 ms at 3.35 TB/s); the
chunk states, written and read three times over, make up most of the
rest.

On CPU tensors it runs ``ssd_scan_plain``, the plain chunked scan
``repro_torch.models.ssm.ssd_chunked`` with one group.  An initial state
``h0`` is taken as ``ssd_chunked`` takes it.  Meta tensors (the dry run)
get empty outputs and add ``scan_flops`` to ``kernels.meta_flops()``;
the workspace, whose sizes only the built kernel source reports, is not
allocated there.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, add_meta_flops, count_launch

_C = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_C] * 11 + [_I] * 6 + [_C]
_FN = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
MAX_CHUNK = 256
MAX_P = 128
MAX_N = 128
PASSES = ("ssd_prologue", "ssd_states", "ssd_state_passing", "ssd_output")


def workspace_elems(B: int, L: int, H: int, P: int, N: int,
                    chunk: int) -> list[int]:
    """Float32 elements of the workspace buffers one call allocates (cs,
    C.B^T, chunk states), as the kernel source sizes them (builds the
    kernels)."""
    _check_range(chunk, P, N)
    elems = (ctypes.c_longlong * 3)()
    fn = _build.function("ssd_scan_workspace",
                         [_I] * 6 + [ctypes.POINTER(ctypes.c_longlong)])
    _build.check(fn(B, L, H, P, N, chunk, elems), "ssd_scan_workspace")
    return list(elems)


def launch_info(B: int, L: int, H: int, P: int, N: int, chunk: int,
                dtype: torch.dtype) -> dict:
    """How one call launches on the current card (builds the kernels):
    for each of its kernels, in order, the grid's CTAs, threads per CTA,
    dynamic shared memory bytes and CTAs resident per SM by the
    occupancy calculator; and the workspace bytes."""
    _check_range(chunk, P, N)
    info = (ctypes.c_int * (5 * len(PASSES)))()
    fn = _build.function("ssd_scan_launch_info",
                         [_I] * 7 + [ctypes.POINTER(ctypes.c_int)])
    _build.check(fn(int(dtype == torch.bfloat16), B, L, H, P, N, chunk,
                    info), "ssd_scan_launch_info")
    kernels = [{"name": name, "ctas": info[5 * k],
                "threads": info[5 * k + 1], "smem_bytes": info[5 * k + 2],
                "ctas_per_sm": info[5 * k + 3]}
               for k, name in enumerate(PASSES)]
    return {"kernels": kernels,
            "workspace_bytes": 4 * sum(workspace_elems(B, L, H, P, N,
                                                       chunk))}


def _check_range(chunk: int, P: int, N: int) -> None:
    if not (1 <= chunk <= MAX_CHUNK and 1 <= P <= MAX_P
            and 1 <= N <= MAX_N):
        raise ValueError(f"ssd_scan: chunk={chunk} (max {MAX_CHUNK}), P={P} "
                         f"(max {MAX_P}), N={N} (max {MAX_N}) outside the "
                         f"kernel's range")


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


def scan_flops(B: int, L: int, H: int, P: int, N: int, chunk: int
               ) -> float:
    """Operations of the chunked scan over ceil(L / chunk) chunks: C.B^T
    (2 Q^2 N), the masked intra-chunk product with x (2 Q^2 H P), the
    chunk states and the inter-chunk output (2 Q H N P each)."""
    Q = chunk
    nc = -(-L // Q)
    return float(B) * nc * (2 * Q * Q * N + 2 * Q * Q * H * P
                            + 4 * Q * H * N * P)


def _meta(x, Bm, chunk):
    """Meta tensors: float32 y and h_final of the kernel's shapes, and its
    operations in ``kernels.meta_flops()``."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    add_meta_flops("ssd_scan", scan_flops(Bsz, L, H, P, N, chunk))
    return (torch.empty((Bsz, L, H, P), dtype=torch.float32, device="meta"),
            torch.empty((Bsz, H, N, P), dtype=torch.float32, device="meta"))


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
    ws = [torch.empty(n, dtype=torch.float32, device=dev)
          for n in workspace_elems(Bsz, L, H, P, N, chunk)]
    fn = _build.function(_FN[x.dtype], _ARGTYPES)
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
             Cm.data_ptr(), h0.data_ptr() if h0 is not None else None,
             y.data_ptr(), h_out.data_ptr(), *(w.data_ptr() for w in ws),
             Bsz, L, H, P, N, chunk, _build.current_stream(dev.index))
    _build.check(err, _FN[x.dtype])
    count_launch("ssd_scan")
    return y, h_out


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int, *,
             h0: torch.Tensor | None = None):
    """x [B, L, H, P]; dt [B, L, H]; A [H]; Bm/Cm [B, L, N] or
    [B, L, 1, N]; optional h0 [B, H, N, P].  Returns (y [B, L, H, P],
    h_final [B, H, N, P]), both float32.  G > 1 and a chunk, P or N
    outside the kernel's range are refused on every device."""
    Bm, Cm = _one_group(Bm, "Bm"), _one_group(Cm, "Cm")
    _check_range(chunk, x.shape[-1], Bm.shape[-1])
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk, h0=h0)
    if x.device.type == "meta":
        return _meta(x, Bm, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    return _launch(x, dt, A, Bm, Cm, chunk, h0)
