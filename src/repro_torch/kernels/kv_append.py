"""KV append of the dual-pool decode step.

Replaces the four drop-mode scatters of
``repro.serving.engine._decode_core_pinned``: the new token's K and V
rows of every batch entry land in whichever pool holds its tail page.
Each row carries a slot for both pools; a slot outside its pool's range
writes nothing (the JAX ``mode="drop"`` rule), so the caller points the
pool that does not hold the tail at ``n_slots``.

The pools are per-layer views ``pool[:, l]`` of the
``[slots, L, 2, page, Hkv, D]`` page pools.  The packed prefill appends
all L rows of a bucket in one call, into one pool (``pin=None``) or two;
its padding rows carry an out-of-range slot and are dropped.  On the card
``csrc/kv_append.cu`` writes them in place — the second pool is pinned
host memory, reached through its mapped device address; CPU tensors take
``kv_append_plain``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, count_launch

_C = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_C] * 7 + [_I] * 4 + [_L] * 6 + [_C]
_FN = {torch.float32: "kv_append_f32", torch.bfloat16: "kv_append_bf16"}


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


def _launch(fast, pin, f_idx, p_idx, off, k, v) -> None:
    B = k.shape[0]
    n_pin = 0 if pin is None else pin.shape[0]
    if pin is None:              # one pool: no second-pool row is in range
        pin, p_idx = fast, f_idx
    dev = k.device
    if fast.dtype not in _FN or pin.dtype != fast.dtype \
            or k.dtype != fast.dtype or v.dtype != fast.dtype:
        raise TypeError(f"kv_append: pools and k/v must share float32 or "
                        f"bfloat16, got {fast.dtype}/{pin.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    row = k[0].numel() if B else 0
    for name, t in (("fast", fast), ("pin", pin)):
        # [slots, 2, page, Hkv, D] with each Hkv*D row contiguous
        if t.dim() != 5 or t.shape[1:] != fast.shape[1:] \
                or t.stride(4) != 1 or t.stride(3) != t.shape[4]:
            raise ValueError(f"kv_append: {name} pool view "
                             f"{tuple(t.shape)} is not [slots, 2, page, "
                             f"Hkv, D] with contiguous rows")
    if k.shape != v.shape or k.shape[1:] != fast.shape[3:] \
            or not k.is_contiguous() or not v.is_contiguous() \
            or v.device != dev or fast.device != dev:
        raise ValueError("kv_append: k/v must be contiguous [B, Hkv, D] on "
                         "the tier-0 pool's device")
    for name, t in (("f_idx", f_idx), ("p_idx", p_idx), ("off", off)):
        if t.dtype != torch.int32 or t.shape != (B,) \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"kv_append: {name} must be a contiguous int32 "
                             f"[B] vector on {dev}")
    if B == 0 or row == 0:              # nothing to launch, nothing counted
        return
    fs, ps = fast.stride(), pin.stride()
    fn = _build.function(_FN[fast.dtype], _ARGTYPES)
    err = fn(fast.data_ptr(), _build.device_address(pin), f_idx.data_ptr(),
             p_idx.data_ptr(), off.data_ptr(), k.data_ptr(), v.data_ptr(),
             B, row, fast.shape[0], n_pin, fs[0], fs[1], fs[2],
             ps[0], ps[1], ps[2], _build.current_stream(dev.index))
    _build.check(err, _FN[fast.dtype])
    count_launch("kv_append")


def kv_append(fast: torch.Tensor, pin: torch.Tensor | None,
              f_idx: torch.Tensor, p_idx: torch.Tensor | None,
              off: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write k/v [B, Hkv, D] at in-page offset ``off`` of slot ``f_idx`` of
    the tier-0 view ``fast`` and slot ``p_idx`` of the second view ``pin``
    (both [slots, 2, page, Hkv, D]; ``pin`` and ``p_idx`` None for one
    pool); out-of-range slots write nothing."""
    if k.device.type == "cpu":
        kv_append_plain(fast, pin, f_idx, p_idx, off, k, v)
        return
    if k.device.type != "cuda":
        raise ValueError(f"kv_append: unsupported device {k.device}")
    _launch(fast, pin, f_idx, p_idx, off, k.to(fast.dtype).contiguous(),
            v.to(fast.dtype).contiguous())
