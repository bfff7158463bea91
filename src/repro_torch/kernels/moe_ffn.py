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

``moe_ffn_train`` is the forward for training, float32 or bfloat16: the
same two launches, bits and count, its gate/up entry also storing the
float32 products g = xg . W_gate[e] and u = xg . W_up[e] beside h, which
it returns for the backward (``moe_ffn_train_plain`` on the CPU).

``moe_ffn_backward`` is the gradient, from the forward's g, u and h.
The bfloat16 entry (``csrc/moe_ffn_bwd.cu``'s ``moe_ffn_bwd_bf16``,
three launches on bf16 ``wgmma`` with float32 accumulation) takes the
rounding points of the gradient XLA derives from ``_grouped_ffn``: dh
rounded to bf16, dx the bf16 sum of two bf16-rounded products, the
weight gradients in bf16, dgate in float32; dg, du, dy and c dy enter
its products rounded to bf16 (c dy once, into scratch [R, d] that the
down dgrad writes for the weight gradients).  Each launch walks a
persistent grid of 128 x 256 output units, a producer warp streaming
TMA tiles into a ring and two consumer warpgroups on
``wgmma.m64n256k16``; the weight gradients read x, h, dg, du and c dy
as they lie (transposed operands).  On an H100 80GB HBM3 at 700 W it
takes 1.28 ms a call at olmoe's training shape (bound 0.611 ms, bytes;
``torch._grouped_mm``'s six products 3.10) and 11.4-11.6 ms at
mixtral's (8192 rows over 8 experts, d 4096, ff 14336; bound 5.84 ms,
operations; ``torch._grouped_mm`` 16.7), the outputs bit for bit those
of the design before it (6.20 and 72.1 ms; ``tools/moe_bwd_lines.py``).
``bwd_launch_info`` gives each launch's plan.  The float32 gradient: on
CUDA tensors ``csrc/moe_ffn_bwd.cu`` in three launches (the
down product's input gradient with the SwiGLU backward and the gate
weights' partial gradients; the rows' gradient; the three weight
gradients), each counted under ``moe_ffn_bwd``.  All three run 3xTF32 on
``wgmma`` over a persistent grid, a producer warpgroup streaming TMA
tiles and splitting the B operand into its two TF32 terms in shared
memory, the offsets read on the device, no atomics.  At olmoe's training
shape (16384 rows over 64 experts, d 2048, ff 1024) its bound is 12 R d
ff operations at 494.7/3 TFLOP/s, 2.50 ms; on an H100 80GB HBM3 at 700 W
it takes 5.41 ms a call, the parent design (four launches on
``mma.sync``, g and u recomputed) 11.90 in the same run
(``tools/moe_bwd_lines.py``; PERF.md has ``chip_smoke.py``'s row).  CPU
tensors take ``moe_ffn_backward_plain``, bfloat16 ones its bf16-in,
float32-accumulate form with the kernel's rounding points.

Meta tensors (the dry run) get empty outputs of the kernels' shapes and
types, the backward's scratch allocated as on the card, and add the
operations (6 R d ff forward, 12 R d ff backward, from the rows and
widths, not the groups) to ``kernels.meta_flops()``.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, add_meta_flops, count_launch

_C = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_C] * 5 + [_I] * 4 + [_C]
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
TILE = 64          # D and FF must be multiples of the kernel's column tile
MAX_EXPERTS = 256  # the kernel's unit plan in shared memory
BWD_TILE = 128     # columns of h a dc partial of the backward sums
BWD_LAUNCHES = 3   # moe_ffn_bwd's launches a call
_BWD_ARGTYPES = [_I] + [_C] * 19 + [_I] * 5 + [_C]
_BWD16_ARGTYPES = [_I] + [_C] * 19 + [_I] * 4 + [_C]
BWD_LAUNCH_NAMES = ("down_dgrad", "x_dgrad", "weight_grads")
_TRAIN_ARGTYPES = [_C] * 7 + [_I] * 4 + [_C]


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


def moe_ffn_train_plain(xg: torch.Tensor, offs: torch.Tensor,
                        w_gate: torch.Tensor, w_up: torch.Tensor,
                        w_down: torch.Tensor, gate: torch.Tensor):
    """The plain training forward: ``moe_ffn_plain``'s y and h (h in xg's
    type) with the float32 products g = x.Wg[e], u = x.Wu[e] [R, ff] it
    computes on the way.  Returns (y, g, u, h); rows of no expert (none,
    when offs ends at R) stay zero."""
    R, d = xg.shape
    ff = w_gate.shape[2]
    f32 = dict(dtype=torch.float32, device=xg.device)
    y = torch.zeros((R, d), **f32)
    g, u = (torch.zeros((R, ff), **f32) for _ in range(2))
    h = torch.zeros((R, ff), dtype=xg.dtype, device=xg.device)
    bounds = offs.tolist()
    for e in range(len(bounds) - 1):
        a, b = bounds[e], bounds[e + 1]
        if a == b:
            continue
        x = xg[a:b].float()
        g[a:b], u[a:b] = x @ w_gate[e].float(), x @ w_up[e].float()
        h[a:b] = (F.silu(g[a:b]) * u[a:b]).to(xg.dtype)
        y[a:b] = (h[a:b].float() @ w_down[e].float()) * gate[a:b, None]
    return y, g, u, h


def moe_ffn_backward_plain(dy: torch.Tensor, xg: torch.Tensor,
                           offs: torch.Tensor, w_gate: torch.Tensor,
                           w_up: torch.Tensor, w_down: torch.Tensor,
                           gate: torch.Tensor, g: torch.Tensor | None = None,
                           u: torch.Tensor | None = None,
                           h: torch.Tensor | None = None):
    """The plain gradient of ``moe_ffn_plain`` in float32, for output
    gradient dy [R, d]: one ``torch.matmul`` per product and expert, the
    group bounds read on the host.  For sorted row r of expert e with
    gate weight c_r: g = x.Wg, u = x.Wu, a = silu(g), h = a u; t =
    dy.Wd[e]^T, dc_r = sum_f h_rf t_rf, dh = c_r t; dg = dh u silu'(g),
    du = dh a; dxg = dg.Wg^T + du.Wu^T; dWg[e] = X_e^T.dg_e, dWu[e] =
    X_e^T.du_e, dWd[e] = H_e^T.(c dy)_e.  g, u and h [R, ff] are the
    forward's (``moe_ffn_train_plain``) or, left out, computed here the
    same way.  Returns (dxg [R, d], dWg, dWu [E, d, ff], dWd [E, ff, d],
    dgate [R]), all float32; an expert without rows gets zero weight
    gradients.  bfloat16 rows and weights take ``_backward_plain_bf16``,
    the bf16 kernel's arithmetic."""
    if xg.dtype == torch.bfloat16:
        return _backward_plain_bf16(dy, xg, offs, w_gate, w_up, w_down,
                                    gate, g, u, h)
    R, d = xg.shape
    f32 = dict(dtype=torch.float32, device=xg.device)
    dxg = torch.zeros((R, d), **f32)
    dwg = torch.zeros(w_gate.shape, **f32)
    dwu = torch.zeros(w_up.shape, **f32)
    dwd = torch.zeros(w_down.shape, **f32)
    dgate = torch.zeros((R,), **f32)
    bounds = offs.tolist()
    for e in range(len(bounds) - 1):
        a, b = bounds[e], bounds[e + 1]
        if a == b:
            continue
        x, dye, c = xg[a:b].float(), dy[a:b].float(), gate[a:b, None]
        wg, wu, wd = w_gate[e].float(), w_up[e].float(), w_down[e].float()
        ge = x @ wg if g is None else g[a:b]
        ue = x @ wu if u is None else u[a:b]
        s = torch.sigmoid(ge)
        act = F.silu(ge)
        he = act * ue if h is None else h[a:b]
        t = dye @ wd.T
        dgate[a:b] = (he * t).sum(dim=-1)
        dh = c * t
        dg = dh * ue * (s * (1 + ge * (1 - s)))
        du = dh * act
        dxg[a:b] = dg @ wg.T + du @ wu.T
        dwg[e] = x.T @ dg
        dwu[e] = x.T @ du
        dwd[e] = he.T @ (c * dye)
    return dxg, dwg, dwu, dwd, dgate


def _backward_plain_bf16(dy, xg, offs, w_gate, w_up, w_down, gate, g, u,
                         h):
    """``moe_ffn_backward_plain`` for bfloat16 rows and weights: the bf16
    kernel's arithmetic, each product's operands rounded to bf16 and
    multiplied in float32 (``_bf``)."""
    R, d = xg.shape
    dev = xg.device
    bf = torch.bfloat16
    _bf = lambda t: t.to(bf).float()
    dxg = torch.zeros((R, d), dtype=bf, device=dev)
    dwg, dwu = torch.zeros_like(w_gate), torch.zeros_like(w_up)
    dwd = torch.zeros_like(w_down)
    dgate = torch.zeros((R,), dtype=torch.float32, device=dev)
    bounds = offs.tolist()
    for e in range(len(bounds) - 1):
        a, b = bounds[e], bounds[e + 1]
        if a == b:
            continue
        x, c = xg[a:b].float(), gate[a:b, None]
        wg, wu, wd = w_gate[e].float(), w_up[e].float(), w_down[e].float()
        ge = x @ wg if g is None else g[a:b]
        ue = x @ wu if u is None else u[a:b]
        he = _bf(F.silu(ge) * ue) if h is None else h[a:b].float()
        t = _bf(dy[a:b]) @ wd.T
        dgate[a:b] = (he * t).sum(dim=-1)
        dh = _bf(c * t)
        s = torch.sigmoid(ge)
        be = dh * ue
        dg = _bf(be * s + (ge * be) * (s * (1 - s)))
        du = _bf((ge * s) * dh)
        dxg[a:b] = (_bf(dg @ wg.T) + _bf(du @ wu.T)).to(bf)
        dwg[e] = (x.T @ dg).to(bf)
        dwu[e] = (x.T @ du).to(bf)
        dwd[e] = (he.T @ _bf(c * dy[a:b])).to(bf)
    return dxg, dwg, dwu, dwd, dgate


def _check_dtype(xg, name: str) -> None:
    if xg.dtype not in _SUFFIX:
        raise TypeError(f"{name}: float32 or bfloat16 rows, got {xg.dtype}")


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


def _launch(xg, offs, w_gate, w_up, w_down, gate, keep=False):
    """The two launches; ``keep`` (training): the gate/up entry that also
    stores g and u, and (y, g, u, h) returned."""
    _check(xg, offs, w_gate, w_up, w_down, gate)
    R, d = xg.shape
    E, _, ff = w_gate.shape
    dev = xg.device
    y = torch.empty((R, d), dtype=torch.float32, device=dev)
    h = torch.empty((R, ff), dtype=xg.dtype, device=dev)
    gu = [torch.empty((R, ff), dtype=torch.float32, device=dev)
          for _ in range(2 if keep else 0)]
    if R == 0:                          # nothing to launch, nothing counted
        return (y, *gu, h) if keep else y
    sfx = _SUFFIX[xg.dtype]
    stream = _build.current_stream(dev.index)
    if keep:
        name = f"moe_gate_up_{sfx}_train"
        fn = _build.function(name, _TRAIN_ARGTYPES)
        _build.check(fn(xg.data_ptr(), offs.data_ptr(), w_gate.data_ptr(),
                        w_up.data_ptr(), h.data_ptr(), gu[0].data_ptr(),
                        gu[1].data_ptr(), R, E, d, ff, stream), name)
    else:
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
    return (y, *gu, h) if keep else y


def _bwd_buffers(xg, w_gate, w_up, w_down):
    """The backward's outputs (dxg, dWg, dWu, dWd, dgate) and scratch, on
    xg's device: float32 or, for bf16 rows, the bf16 entry's types."""
    R, d = xg.shape
    E, _, ff = w_gate.shape
    f32 = dict(dtype=torch.float32, device=xg.device)
    outs = (torch.empty((R, d), dtype=xg.dtype, device=xg.device),
            torch.empty_like(w_gate), torch.empty_like(w_up),
            torch.empty_like(w_down), torch.empty((R,), **f32))
    part = torch.empty((R, -(-ff // BWD_TILE)), **f32)
    if xg.dtype == torch.bfloat16:      # dg, du and c dy, rounded to bf16
        scratch = [torch.empty((R, n), dtype=xg.dtype, device=xg.device)
                   for n in (ff, ff, d)]
    else:
        # the transposed intermediates: each group from a multiple of 4
        # columns (TMA reads from 16-byte aligned inner coordinates)
        rp = -(-(R + 3 * E) // 4) * 4
        scratch = [torch.empty((ff, rp), **f32) for _ in range(3)]
    return outs, scratch + [part]


def _launch_bwd(dy, xg, offs, w_gate, w_up, w_down, gate, g, u, h):
    _check(xg, offs, w_gate, w_up, w_down, gate)
    R, d = xg.shape
    E, _, ff = w_gate.shape
    if dy.shape != (R, d) or dy.dtype != torch.float32 \
            or dy.device != xg.device or dy.data_ptr() % 16:
        raise ValueError(f"moe_ffn_backward: dy must be float32 {(R, d)} "
                         f"on {xg.device} with a 16-byte aligned base")
    for name, t in (("g", g), ("u", u), ("h", h)):
        want = xg.dtype if name == "h" else torch.float32
        if t is None or t.shape != (R, ff) or t.dtype != want \
                or t.device != xg.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"moe_ffn_backward: the forward's {name} "
                             f"(moe_ffn_train) must be contiguous {want} "
                             f"{(R, ff)} on {xg.device} with a 16-byte "
                             f"aligned base")
    (dxg, dwg, dwu, dwd, dgate), scratch = _bwd_buffers(xg, w_gate, w_up,
                                                        w_down)
    if R == 0:                          # nothing to launch, nothing counted
        return dxg, dwg.zero_(), dwu.zero_(), dwd.zero_(), dgate
    stream = _build.current_stream(xg.device.index)
    if xg.dtype == torch.bfloat16:
        fn = _build.function("moe_ffn_bwd_bf16", _BWD16_ARGTYPES)
        args = (dy, xg, offs, w_gate, w_up, w_down, gate, g, u, h,
                *scratch, dxg, dgate, dwg, dwu, dwd)
        for kind in range(BWD_LAUNCHES):
            _build.check(fn(kind, *(t.data_ptr() for t in args), R, E, d,
                            ff, stream), f"moe_ffn_bwd_bf16[{kind}]")
            count_launch("moe_ffn_bwd")
        return dxg, dwg, dwu, dwd, dgate
    dgt, dut, ht, part = scratch
    rp = dgt.shape[1]
    fn = _build.function("moe_ffn_bwd_f32", _BWD_ARGTYPES)
    for kind in range(BWD_LAUNCHES):
        _build.check(fn(kind, dy.data_ptr(), xg.data_ptr(), offs.data_ptr(),
                        w_gate.data_ptr(), w_up.data_ptr(),
                        w_down.data_ptr(), gate.data_ptr(), g.data_ptr(),
                        u.data_ptr(), h.data_ptr(), dgt.data_ptr(),
                        dut.data_ptr(), ht.data_ptr(), part.data_ptr(),
                        dxg.data_ptr(), dgate.data_ptr(), dwg.data_ptr(),
                        dwu.data_ptr(), dwd.data_ptr(), R, rp, E, d, ff,
                        stream), f"moe_ffn_bwd_f32[{kind}]")
        count_launch("moe_ffn_bwd")
    return dxg, dwg, dwu, dwd, dgate


def ffn_flops(R: int, d: int, ff: int) -> float:
    """Operations of the forward's three products over R rows: 6 R d ff
    (the backward's five: 12 R d ff)."""
    return 6.0 * R * d * ff


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


def bwd_launch_info() -> dict:
    """How each launch of the bf16 ``moe_ffn_bwd`` entry runs on the
    card, for measurement: by launch (``BWD_LAUNCH_NAMES``) the
    persistent grid's CTAs, threads, dynamic shared memory, CTAs per SM,
    ring stages, rows a unit and columns a unit (the kernel source's
    constants)."""
    fn = _build.function("moe_ffn_bwd_bf16_launch_info",
                         [_I, ctypes.POINTER(ctypes.c_int)])
    keys = ("ctas", "threads", "smem_bytes", "ctas_per_sm", "stages",
            "unit_rows", "unit_columns")
    plan = {}
    for kind, name in enumerate(BWD_LAUNCH_NAMES):
        info = (ctypes.c_int * len(keys))()
        _build.check(fn(kind, info), f"moe_ffn_bwd_bf16_launch_info[{kind}]")
        plan[name] = dict(zip(keys, info))
    return plan


def moe_ffn(xg: torch.Tensor, offs: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor,
            gate: torch.Tensor) -> torch.Tensor:
    """Rows sorted by expert xg [R, d] (float32 or bfloat16), int32 group
    offsets offs [E + 1], expert weights w_gate/w_up [E, d, ff] and
    w_down [E, ff, d] in xg's type, float32 gate weights [R].  Returns
    the gated expert outputs y [R, d] in float32.  CPU tensors: the plain
    version; CUDA tensors: the kernel (two launches) or a raise; meta
    tensors: an empty y."""
    if xg.device.type == "cpu":
        return moe_ffn_plain(xg, offs, w_gate, w_up, w_down, gate)
    if xg.device.type == "meta":
        R, d = xg.shape
        add_meta_flops("moe_ffn", ffn_flops(R, d, w_gate.shape[2]))
        return torch.empty((R, d), dtype=torch.float32, device="meta")
    if xg.device.type != "cuda":
        raise ValueError(f"moe_ffn: unsupported device {xg.device}")
    return _launch(xg, offs, w_gate, w_up, w_down, gate)


def moe_ffn_train(xg: torch.Tensor, offs: torch.Tensor,
                  w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor, gate: torch.Tensor):
    """``moe_ffn`` for training, float32 or bfloat16 rows and weights:
    (y [R, d] float32, g, u [R, ff] float32, h [R, ff] in xg's type), y
    and h with ``moe_ffn``'s bits and g, u the gate and up products h was
    made from, kept for ``moe_ffn_backward``.  CPU tensors: the plain
    version; CUDA tensors: the kernel (two launches, the gate/up one
    storing g and u) or a raise; meta tensors: empty outputs."""
    _check_dtype(xg, "moe_ffn_train")
    if xg.device.type == "cpu":
        return moe_ffn_train_plain(xg, offs, w_gate, w_up, w_down, gate)
    if xg.device.type == "meta":
        R, d = xg.shape
        ff = w_gate.shape[2]
        add_meta_flops("moe_ffn", ffn_flops(R, d, ff))
        f32 = dict(dtype=torch.float32, device="meta")
        return (torch.empty((R, d), **f32), torch.empty((R, ff), **f32),
                torch.empty((R, ff), **f32),
                torch.empty((R, ff), dtype=xg.dtype, device="meta"))
    if xg.device.type != "cuda":
        raise ValueError(f"moe_ffn_train: unsupported device {xg.device}")
    return _launch(xg, offs, w_gate, w_up, w_down, gate, keep=True)


def moe_ffn_backward(dy: torch.Tensor, xg: torch.Tensor, offs: torch.Tensor,
                     w_gate: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor, gate: torch.Tensor,
                     g: torch.Tensor | None = None,
                     u: torch.Tensor | None = None,
                     h: torch.Tensor | None = None):
    """The gradient of ``moe_ffn`` for output gradient dy [R, d] (float32),
    from the forward's g, u and h (``moe_ffn_train``): (dxg [R, d] in xg's
    type, dWg, dWu [E, d, ff], dWd [E, ff, d] in the weights' type, dgate
    [R] float32).  CPU tensors: the plain version (which computes g, u
    and h when they are left out); CUDA tensors: the kernels (three
    launches), which need them, or a raise; meta tensors: empty outputs
    and the scratch the kernels take."""
    _check_dtype(xg, "moe_ffn_backward")
    if xg.device.type == "cpu":
        return moe_ffn_backward_plain(dy, xg, offs, w_gate, w_up, w_down,
                                      gate, g, u, h)
    if xg.device.type == "meta":
        R, d = xg.shape
        add_meta_flops("moe_ffn_bwd", 2 * ffn_flops(R, d, w_gate.shape[2]))
        return _bwd_buffers(xg, w_gate, w_up, w_down)[0]
    if xg.device.type != "cuda":
        raise ValueError(f"moe_ffn_backward: unsupported device "
                         f"{xg.device}")
    return _launch_bwd(dy.contiguous(), xg, offs, w_gate, w_up, w_down, gate,
                       g, u, h)
