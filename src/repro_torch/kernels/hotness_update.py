"""K2 — SysMon's per-sampling touch histogram (``touch_update``), and
K7 — the pass-boundary sweep (``sysmon_pass``, at the end of the module).

Replaces ``repro.kernels.hotness_update.hotness_update.touch_update_pallas``
and the JAX op around it (``repro.kernels.hotness_update.ops.
touch_update``), which normalises the event list first: ids clipped in
bounds, invalid events weigh 0, reads and writes split by ``is_write``.
On CUDA tensors that normalisation happens inside the kernel
(``csrc/touch_update.cu``): ``touch_update`` hands it the raw ids, the
``valid`` mask and ``is_write`` (a flag or a bool vector) and SysMon's
sampling is one launch with no zero fill.  On CPU tensors the
normalisation stays here, in Python, before ``touch_update_plain``.
``touch_update_events`` takes explicit int32 weights (the same kernel).
Integer atomics are exact, so kernel and plain version agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, count_launch

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
_fn = None                               # the C entry, resolved once


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


def _launch(n_pages: int, ids, r, w, valid, is_write, write_flag: bool):
    """One launch: explicit int32 weights ``r``/``w``, or weights derived
    in the kernel from the bool ``valid`` (None: all valid) and the bool
    ``is_write`` vector (None: every event is ``write_flag``).  The host
    work is one check per operand, one allocation and the call: SysMon
    samples twice per decode step."""
    global _fn
    k, card = ids.numel(), ids.get_device()
    for t, dtype in ((ids, torch.int32), (r, torch.int32), (w, torch.int32),
                     (valid, torch.bool), (is_write, torch.bool)):
        if t is not None and (t.dtype is not dtype or t.dim() != 1
                              or t.numel() != k or t.get_device() != card
                              or not t.is_contiguous()):
            raise ValueError("touch_update: ids, r, w (int32) and valid, "
                             "is_write (bool) must be contiguous vectors "
                             "of one length on one device")
    if k == 0:                          # nothing to launch, nothing counted
        return ids.new_zeros((3, n_pages)).unbind(0)
    out = ids.new_empty((3, n_pages))
    if _fn is None:
        _fn = _build.function("touch_update", _ARGTYPES)
    err = _fn(ids.data_ptr(), None if r is None else r.data_ptr(),
              None if w is None else w.data_ptr(),
              None if valid is None else valid.data_ptr(),
              None if is_write is None else is_write.data_ptr(),
              write_flag, k, n_pages, out.data_ptr(),
              _build.current_stream(card))
    _build.check(err, "touch_update")
    count_launch("touch_update")
    return out.unbind(0)


def touch_update_events(n_pages: int, ids: torch.Tensor, r: torch.Tensor,
                        w: torch.Tensor):
    """Kernel dispatch over an already-normalised event list."""
    if ids.is_cuda:
        return _launch(n_pages, ids, r, w, None, None, False)
    if ids.device.type != "cpu":
        raise ValueError(f"touch_update: unsupported device {ids.device}")
    return touch_update_plain(n_pages, ids, r, w)


def _vector(t: torch.Tensor, k: int | None = None,
            dtype: torch.dtype | None = None) -> torch.Tensor:
    """``t`` as a contiguous vector (of ``dtype`` and broadcast to ``k``
    entries if given), with no op where it already is one."""
    if dtype is not None and t.dtype is not dtype:
        t = t.to(dtype)
    if t.dim() != 1:
        t = t.reshape(-1)
    if k is not None and t.shape[0] != k:
        t = t.expand(k)
    return t if t.is_contiguous() else t.contiguous()


def touch_update(n_pages: int, page_ids: torch.Tensor, is_write=False,
                 valid: torch.Tensor | None = None):
    """Dense per-page increments for one SysMon sampling.

    page_ids: int [k] touched pages (may repeat; clipped in bounds);
    is_write: bool or bool [k]; valid: optional bool [k] mask for padded
    id lists.  Returns int32 [n_pages] (d_reads, d_writes, touched) —
    counts accumulate duplicates, touched dedupes to {0, 1}."""
    dev = page_ids.device
    if dev.type == "cuda":
        ids = page_ids
        if ids.dtype != torch.int32:    # clip before narrowing, as JAX
            ids = ids.clamp(0, n_pages - 1).to(torch.int32)
        ids = _vector(ids)
        k = ids.shape[0]
        flag = isinstance(is_write, bool)
        return _launch(
            n_pages, ids, None, None,
            None if valid is None else _vector(valid, k, torch.bool),
            None if flag else _vector(is_write, k, torch.bool),
            is_write if flag else False)
    if dev.type != "cpu":
        raise ValueError(f"touch_update: unsupported device {dev}")
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
    return touch_update_plain(n_pages, ids.contiguous(), r, w)


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
             _build.current_stream(reads.device.index))
    _build.check(err, "sysmon_pass")
    count_launch("sysmon_pass")
    return wd_code, new_hist, future
