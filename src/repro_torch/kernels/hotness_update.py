"""K2 — SysMon's per-sampling touch histogram (``touch_update``).

Replaces ``repro.kernels.hotness_update.hotness_update.touch_update_pallas``.
``touch_update`` normalises the event list exactly as the JAX wrapper
(``repro.kernels.hotness_update.ops.touch_update``) does — ids clipped
in bounds, invalid events weigh 0 — then launches
``csrc/touch_update.cu`` on CUDA tensors or runs ``touch_update_plain``
on CPU tensors.  Integer atomics are exact, so both agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, count_launch

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 4


def touch_update_plain(n_pages: int, ids: torch.Tensor, r: torch.Tensor,
                       w: torch.Tensor):
    """Dense int32 [n_pages] (d_reads, d_writes, touched) from in-bounds
    ids and 0/1 int32 event weights."""
    idx = ids.long()
    z = torch.zeros(n_pages, dtype=torch.int32, device=ids.device)
    d_reads = z.clone().index_add_(0, idx, r)
    d_writes = z.clone().index_add_(0, idx, w)
    touched = z.scatter_reduce_(0, idx, torch.clamp(r + w, max=1),
                                reduce="amax")
    return d_reads, d_writes, touched


def _launch(n_pages: int, ids, r, w):
    for name, t in (("ids", ids), ("r", r), ("w", w)):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != ids.device or t.shape != ids.shape:
            raise ValueError(f"touch_update: {name} must be a contiguous "
                             f"int32 vector on {ids.device} shaped like ids")
    z = torch.zeros(3, n_pages, dtype=torch.int32, device=ids.device)
    d_reads, d_writes, touched = z[0], z[1], z[2]
    if ids.numel() == 0:                # nothing to launch, nothing counted
        return d_reads, d_writes, touched
    fn = _build.function("touch_update", _ARGTYPES)
    err = fn(ids.data_ptr(), r.data_ptr(), w.data_ptr(), ids.numel(),
             d_reads.data_ptr(), d_writes.data_ptr(), touched.data_ptr(),
             torch.cuda.current_stream(ids.device).cuda_stream)
    _build.check(err, "touch_update")
    count_launch("touch_update")
    return d_reads, d_writes, touched


def touch_update_events(n_pages: int, ids: torch.Tensor, r: torch.Tensor,
                        w: torch.Tensor):
    """Kernel dispatch over an already-normalised event list."""
    if ids.device.type == "cpu":
        return touch_update_plain(n_pages, ids, r, w)
    if ids.device.type != "cuda":
        raise ValueError(f"touch_update: unsupported device {ids.device}")
    return _launch(n_pages, ids, r, w)


def touch_update(n_pages: int, page_ids: torch.Tensor, is_write=False,
                 valid: torch.Tensor | None = None):
    """Dense per-page increments for one SysMon sampling.

    page_ids: int [k] touched pages (may repeat; clipped in bounds);
    is_write: bool or bool [k]; valid: optional bool [k] mask for padded
    id lists.  Returns int32 [n_pages] (d_reads, d_writes, touched) —
    counts accumulate duplicates, touched dedupes to {0, 1}."""
    dev = page_ids.device
    ids = page_ids.reshape(-1).clamp(0, n_pages - 1).to(torch.int32)
    k = ids.shape[0]
    if isinstance(is_write, bool):
        is_write = torch.full((k,), is_write, dtype=torch.bool, device=dev)
    is_write = is_write.reshape(-1).expand(k)
    if valid is None:
        valid = torch.ones(k, dtype=torch.bool, device=dev)
    valid = valid.reshape(-1).expand(k)
    r = (valid & ~is_write).to(torch.int32)
    w = (valid & is_write).to(torch.int32)
    return touch_update_events(n_pages, ids.contiguous(), r, w)
