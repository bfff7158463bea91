"""The grouped SwiGLU expert FFN of a mixture-of-experts layer
(``moe_ffn``).

It replaces the three ``lax.ragged_dot`` products that the JAX package
leaves to XLA (``repro.models.moe._grouped_ffn``): for rows sorted by
expert ``xg [R, d]`` with group offsets ``offs [E+1]`` (group ``e`` is
rows ``offs[e]:offs[e+1]``),

    h = (silu(xg . W_gate[e]) * (xg . W_up[e])).to(xg.dtype)
    y = (h . W_down[e]) * gate[:, None]                    float32 [R, d]

with every product accumulated in float32.  On CUDA tensors
``csrc/moe_ffn.cu`` computes it in two launches (gate/up, then down)
that read the offsets on the device, so a decode step never waits on the
host for the group sizes; each launch counts once under ``moe_ffn``.
bfloat16 runs on ``wgmma`` from TMA-loaded tiles, float32 in 3xTF32 on
``mma.sync``, both over a persistent grid of (expert, column tile, row
tile) units.  CPU tensors take ``moe_ffn_plain``, a per-expert loop of
``torch.matmul``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, count_launch

_C = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_C] * 5 + [_I] * 4 + [_C]
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
TILE = 64          # D and FF must be multiples of the kernel's column tile
MAX_EXPERTS = 256  # the kernel's unit plan in shared memory


def moe_ffn_plain(xg: torch.Tensor, offs: torch.Tensor,
                  w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """The plain version: one float32 ``torch.matmul`` per product and
    expert, the group bounds read on the host."""
    R, d = xg.shape
    y = torch.zeros((R, d), dtype=torch.float32, device=xg.device)
    bounds = offs.tolist()
    for e in range(len(bounds) - 1):
        a, b = bounds[e], bounds[e + 1]
        if a == b:
            continue
        x = xg[a:b].float()
        h = (F.silu(x @ w_gate[e].float()) * (x @ w_up[e].float())).to(
            xg.dtype)
        y[a:b] = (h.float() @ w_down[e].float()) * gate[a:b, None]
    return y


def _check(xg, offs, w_gate, w_up, w_down, gate) -> None:
    R, d = xg.shape
    E, _, ff = w_gate.shape
    dt, dev = xg.dtype, xg.device
    if dt not in _SUFFIX or any(w.dtype != dt for w in (w_gate, w_up,
                                                        w_down)):
        raise TypeError(f"moe_ffn: rows and weights must share float32 or "
                        f"bfloat16, got {dt}/{w_gate.dtype}/{w_up.dtype}/"
                        f"{w_down.dtype}")
    if w_gate.shape != (E, d, ff) or w_up.shape != (E, d, ff) \
            or w_down.shape != (E, ff, d) or d % TILE or ff % TILE:
        raise ValueError(f"moe_ffn: xg {tuple(xg.shape)}, w_gate/w_up "
                         f"{tuple(w_gate.shape)}/{tuple(w_up.shape)}, w_down "
                         f"{tuple(w_down.shape)} are not [R, d], [E, d, ff] "
                         f"and [E, ff, d] with d and ff multiples of {TILE}")
    if offs.dtype != torch.int32 or offs.shape != (E + 1,):
        raise ValueError(f"moe_ffn: offs must be int32 [E + 1] = [{E + 1}]")
    if E > MAX_EXPERTS:
        raise ValueError(f"moe_ffn: {E} experts, the kernel takes at most "
                         f"{MAX_EXPERTS}")
    if gate.dtype != torch.float32 or gate.shape != (R,):
        raise ValueError(f"moe_ffn: gate must be float32 [R] = [{R}]")
    for name, t in (("xg", xg), ("offs", offs), ("w_gate", w_gate),
                    ("w_up", w_up), ("w_down", w_down), ("gate", gate)):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"moe_ffn: {name} must be contiguous on {dev} "
                             f"with a 16-byte aligned base")


def _launch(xg, offs, w_gate, w_up, w_down, gate) -> torch.Tensor:
    _check(xg, offs, w_gate, w_up, w_down, gate)
    R, d = xg.shape
    E, _, ff = w_gate.shape
    dev = xg.device
    y = torch.empty((R, d), dtype=torch.float32, device=dev)
    if R == 0:                          # nothing to launch, nothing counted
        return y
    h = torch.empty((R, ff), dtype=xg.dtype, device=dev)
    sfx = _SUFFIX[xg.dtype]
    stream = _build.current_stream(dev.index)
    fn = _build.function(f"moe_gate_up_{sfx}", _ARGTYPES)
    _build.check(fn(xg.data_ptr(), offs.data_ptr(), w_gate.data_ptr(),
                    w_up.data_ptr(), h.data_ptr(), R, E, d, ff, stream),
                 f"moe_gate_up_{sfx}")
    count_launch("moe_ffn")
    fn = _build.function(f"moe_down_{sfx}", _ARGTYPES)
    _build.check(fn(h.data_ptr(), offs.data_ptr(), w_down.data_ptr(),
                    gate.data_ptr(), y.data_ptr(), R, E, d, ff, stream),
                 f"moe_down_{sfx}")
    count_launch("moe_ffn")
    return y


def launch_info(dtype: torch.dtype, R: int, E: int) -> dict:
    """How the entry for ``dtype`` launches on the card at R rows over E
    experts, for measurement: the persistent grid's CTAs, threads,
    dynamic shared memory, CTAs per SM, ring stages, rows a unit and
    weight columns a unit of each launch (the kernel source's
    constants)."""
    if dtype not in _SUFFIX:
        raise TypeError(f"moe_ffn: no entry for {dtype}")
    info = (ctypes.c_int * 8)()
    fn = _build.function("moe_ffn_launch_info",
                         [_I, _I, _I, ctypes.POINTER(ctypes.c_int)])
    _build.check(fn(int(dtype == torch.float32), R, E, info),
                 "moe_ffn_launch_info")
    keys = ("ctas", "threads", "smem_bytes", "ctas_per_sm", "stages",
            "unit_rows", "gate_up_unit_columns", "down_unit_columns")
    return dict(zip(keys, info))


def moe_ffn(xg: torch.Tensor, offs: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor,
            gate: torch.Tensor) -> torch.Tensor:
    """Rows sorted by expert xg [R, d] (float32 or bfloat16), int32 group
    offsets offs [E + 1], expert weights w_gate/w_up [E, d, ff] and
    w_down [E, ff, d] in xg's type, float32 gate weights [R].  Returns
    the gated expert outputs y [R, d] in float32.  CPU tensors: the plain
    version; CUDA tensors: the kernel (two launches) or a raise."""
    if xg.device.type == "cpu":
        return moe_ffn_plain(xg, offs, w_gate, w_up, w_down, gate)
    if xg.device.type != "cuda":
        raise ValueError(f"moe_ffn: unsupported device {xg.device}")
    return _launch(xg, offs, w_gate, w_up, w_down, gate)
