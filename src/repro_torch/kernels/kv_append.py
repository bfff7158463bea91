"""The KV append of a decode step or a packed prefill, fused with the
qk-norm, RoPE and q scaling that feed it (``qkv_rope_append``), and the
masked append that is part of its plain version.

``qkv_rope_append`` takes one layer's raw q/k/v projections, applies the
per-head RMSNorm (where the config has qk-norm) and RoPE to q and k,
writes the rotated K and the plain V of every row into the page pool(s)
and returns q pre-scaled by ``D**-0.5`` as [R, Hkv, G, D], ready for the
``_pooled`` paged-attention entries.  It replaces what the JAX package
fuses into its jitted dispatch: ``repro.models.attention.project_qkv``'s
norm and RoPE, the q scaling, and the drop-mode scatters of
``repro.serving.engine._decode_core(_pinned)`` and of the packed prefill.

Each row carries a slot for both pools; a slot outside its pool's range
writes nothing (the JAX ``mode="drop"`` rule), so the caller points the
pool that does not hold the row's page at ``n_slots`` (padding rows of a
prefill bucket at both).  The pools are per-layer views ``pool[:, l]`` of
the ``[slots, L, 2, page, Hkv, D]`` page pools; the second (``pin``,
None for one pool) is pinned host memory on the card, written in place
through its mapped device address.

On CUDA tensors ``csrc/kv_append.cu`` does all of it in one launch.  The
plain version, the eager composition ``rms_norm -> apply_rope ->
* D**-0.5 -> kv_append_plain``, is ``repro_torch.models.attention.
rope_append_plain``, beside the ``project_qkv`` whose norm and RoPE it
shares; ``models.attention.rope_append`` sends CPU tensors there and
CUDA tensors here.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, count_launch

_C = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_ARGTYPES = ([_C, _L, _L] * 3 + [_C] * 7 + [_I, _L, _L, _L]
             + [_C, _C, _I, _L, _L, _L] + [_C] + [_I] * 4 + [_F, _F, _C])
_FN = {torch.float32: "qkv_rope_append_f32",
       torch.bfloat16: "qkv_rope_append_bf16"}
MAX_D = 256


def kv_append_plain(fast: torch.Tensor, pin: torch.Tensor,
                    f_idx: torch.Tensor, p_idx: torch.Tensor,
                    off: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> None:
    """pool[idx[b], 0/1, off[b]] = k/v[b] for every in-range idx of each
    pool (masked index_put: out-of-range rows are dropped; a pool in
    host memory is written from the host)."""
    for pool, idx in ((fast, f_idx), (pin, p_idx)):
        if pool is None:
            continue
        keep = (idx >= 0) & (idx < pool.shape[0])
        if bool(keep.any()):
            dev = pool.device
            rows, o = idx[keep].long().to(dev), off[keep].long().to(dev)
            pool[rows, 0, o] = k[keep].to(dev, pool.dtype)
            pool[rows, 1, o] = v[keep].to(dev, pool.dtype)


def kv_append(fast: torch.Tensor, pin: torch.Tensor | None,
              f_idx: torch.Tensor, p_idx: torch.Tensor | None,
              off: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write k/v [B, Hkv, D] at in-page offset ``off`` of slot ``f_idx`` of
    the tier-0 view ``fast`` and slot ``p_idx`` of the second view ``pin``
    (both [slots, 2, page, Hkv, D]; ``pin`` and ``p_idx`` None for one
    pool); out-of-range slots write nothing.  CPU tensors only: on the
    card the append runs inside ``qkv_rope_append``."""
    if k.device.type != "cpu":
        raise ValueError(f"kv_append: {k.device} tensors append through "
                         f"qkv_rope_append")
    kv_append_plain(fast, pin, f_idx, p_idx, off, k, v)


def _launch(q, k, v, q_norm, k_norm, cos, sin, fast, pin, f_idx, p_idx,
            off, eps) -> torch.Tensor:
    R, Hq, D = q.shape
    Hkv = k.shape[1]
    dev = q.device
    dt = fast.dtype
    n_pin = 0 if pin is None else pin.shape[0]
    if pin is None:              # one pool: no second-pool row is in range
        pin, p_idx = fast, f_idx
    if dt not in _FN or any(t.dtype != dt for t in (pin, q, k, v)):
        raise TypeError(f"qkv_rope_append: pools and q/k/v must share "
                        f"float32 or bfloat16, got {fast.dtype}/{pin.dtype}/"
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (R, Hkv, D) or v.shape != k.shape or Hkv < 1 \
            or Hq % Hkv or D % 2 or not 2 <= D <= MAX_D:
        raise ValueError(f"qkv_rope_append: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"[R, Hq, D] and [R, Hkv, D] with Hkv | Hq and an "
                         f"even D <= {MAX_D}")
    el = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        # pairs (2i, 2i+1) load as one 2-element vector
        if t.device != dev or t.stride(2) != 1 or t.stride(0) % 2 \
                or t.stride(1) % 2 or t.data_ptr() % (2 * el):
            raise ValueError(f"qkv_rope_append: {name} must lie on {dev} "
                             f"with unit-stride D, even strides and a "
                             f"pair-aligned base")
    for name, t in (("q_norm", q_norm), ("k_norm", k_norm)):
        if (t is None) != (q_norm is None) or t is not None and (
                t.shape != (D,) or t.dtype != dt or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"qkv_rope_append: {name} must be a contiguous "
                             f"[D] {dt} vector on {dev}, given with its "
                             f"partner or not at all")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or t.shape != (R, D // 2) \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"qkv_rope_append: {name} must be a contiguous "
                             f"float32 [R, D/2] table on {dev}")
    for name, t in (("fast", fast), ("pin", pin)):
        # [slots, 2, page, Hkv, D] with each Hkv*D row contiguous
        if t.dim() != 5 or t.shape[1:] != fast.shape[1:] \
                or t.shape[3:] != (Hkv, D) or t.stride(4) != 1 \
                or t.stride(3) != D:
            raise ValueError(f"qkv_rope_append: {name} pool view "
                             f"{tuple(t.shape)} is not [slots, 2, page, "
                             f"{Hkv}, {D}] with contiguous rows")
    if fast.device != dev:
        raise ValueError("qkv_rope_append: the tier-0 pool must lie on q's "
                         "device")
    for name, t in (("f_idx", f_idx), ("p_idx", p_idx), ("off", off)):
        if t.dtype != torch.int32 or t.shape != (R,) \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"qkv_rope_append: {name} must be a contiguous "
                             f"int32 [R] vector on {dev}")
    q_out = torch.empty((R, Hkv, Hq // Hkv, D), dtype=dt, device=dev)
    if R == 0:                          # nothing to launch, nothing counted
        return q_out
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    fs, ps = fast.stride(), pin.stride()
    fn = _build.function(_FN[dt], _ARGTYPES)
    err = fn(q.data_ptr(), qs[0], qs[1], k.data_ptr(), ks[0], ks[1],
             v.data_ptr(), vs[0], vs[1],
             None if q_norm is None else q_norm.data_ptr(),
             None if k_norm is None else k_norm.data_ptr(),
             cos.data_ptr(), sin.data_ptr(), q_out.data_ptr(),
             fast.data_ptr(), f_idx.data_ptr(), fast.shape[0], fs[0], fs[1],
             fs[2], _build.device_address(pin), p_idx.data_ptr(), n_pin,
             ps[0], ps[1], ps[2], off.data_ptr(), R, Hq, Hkv, D, D ** -0.5,
             eps, _build.current_stream(dev.index))
    _build.check(err, _FN[dt])
    count_launch("qkv_rope_append")
    return q_out


def qkv_rope_append(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_norm: torch.Tensor | None, k_norm: torch.Tensor | None,
                    cos: torch.Tensor, sin: torch.Tensor, fast: torch.Tensor,
                    pin: torch.Tensor | None, f_idx: torch.Tensor,
                    p_idx: torch.Tensor | None, off: torch.Tensor, *,
                    eps: float) -> torch.Tensor:
    """One layer's raw projections q [R, Hq, D], k/v [R, Hkv, D] (bias
    added), qk-norm weights [D] (or None) with the norm's ``eps``,
    float32 RoPE tables cos/sin [R, D/2]: K rotated and V written at
    in-page offset ``off`` of slot ``f_idx`` of ``fast`` and slot
    ``p_idx`` of ``pin`` (views [slots, 2, page, Hkv, D]; ``pin``/
    ``p_idx`` None for one pool; out-of-range slots write nothing).
    Returns q normed, rotated and scaled by D**-0.5 as [R, Hkv, G, D] in
    the pool dtype.  CUDA tensors only: CPU tensors take
    ``models.attention.rope_append_plain``."""
    if q.device.type != "cuda":
        raise ValueError(f"qkv_rope_append: {q.device} tensors take "
                         f"models.attention.rope_append_plain")
    return _launch(q, k, v, q_norm, k_norm, cos, sin, fast, pin, f_idx,
                   p_idx, off, eps)
