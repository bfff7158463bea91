"""K2 — SysMon's per-sampling touch histogram (``touch_update``), and
K7 — the pass-boundary sweep (``sysmon_pass``, at the end of the module).

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


# =============================================================================
# K7 — the pass-boundary sweep
# =============================================================================
# Replaces ``repro.kernels.hotness_update.hotness_update.sysmon_pass_pallas``
# (the pass sweep the JAX runtime composes from tensor ops in
# ``core/sysmon.py::end_pass``).  The codes and thresholds are the port's
# own copies in ``core/patterns.py`` and ``core/predictor.py``, handed to
# the CUDA kernel as arguments so no constant is restated in C.  They are
# imported inside the functions: ``core.sysmon`` imports this module.

_PASS_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


def sysmon_pass_plain(reads: torch.Tensor, writes: torch.Tensor,
                      hist: torch.Tensor):
    """The tensor composition: ``classify_wd``, ``push_history``,
    ``predict_future``.  int32 [n] in, int32 (wd_code, new_hist, future)
    out."""
    from repro_torch.core import patterns, predictor
    wd_code = patterns.classify_wd(reads, writes)
    new_hist = predictor.push_history(
        hist.to(torch.int32), (wd_code == patterns.WD).to(torch.int32))
    future = predictor.predict_future(new_hist)
    return (wd_code.to(torch.int32), new_hist.to(torch.int32),
            future.to(torch.int32))


def sysmon_pass(reads: torch.Tensor, writes: torch.Tensor,
                hist: torch.Tensor):
    """(wd_code, new_hist, future) int32 [n] from the pass counters and
    the WD history, in one launch on the card."""
    if reads.device.type == "cpu":
        return sysmon_pass_plain(reads, writes, hist)
    if reads.device.type != "cuda":
        raise ValueError(f"sysmon_pass: unsupported device {reads.device}")
    from repro_torch.core import patterns, predictor
    for name, t in (("reads", reads), ("writes", writes), ("hist", hist)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous() \
                or t.device != reads.device or t.shape != reads.shape:
            raise ValueError(f"sysmon_pass: {name} must be a contiguous "
                             f"int32 vector on {reads.device} shaped like "
                             f"reads")
    out = torch.empty((3, reads.shape[0]), dtype=torch.int32,
                      device=reads.device)
    wd_code, new_hist, future = out[0], out[1], out[2]
    if reads.numel() == 0:              # nothing to launch, nothing counted
        return wd_code, new_hist, future
    fn = _build.function("sysmon_pass", _PASS_ARGS)
    err = fn(reads.data_ptr(), writes.data_ptr(), hist.data_ptr(),
             wd_code.data_ptr(), new_hist.data_ptr(), future.data_ptr(),
             reads.shape[0], patterns.WRITE_WEIGHT, patterns.COLD,
             patterns.RD, patterns.WD, predictor.WINDOW_LEN, predictor.K_LEN,
             predictor.HI_THRESH, predictor.LO_THRESH, predictor.UN_WD,
             predictor.WD_FREQ_L, predictor.WD_FREQ_H,
             torch.cuda.current_stream(reads.device).cuda_stream)
    _build.check(err, "sysmon_pass")
    count_launch("sysmon_pass")
    return wd_code, new_hist, future
