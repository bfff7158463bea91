"""K4 — NVM wear-counter scatter-add.

Replaces ``repro.kernels.wear_update.wear_update.wear_update_pallas``.
``wear_update`` keeps the eager JAX caller's normalisation
(``repro.kernels.wear_update.ops.wear_update``): ids clipped in bounds,
masked events zeroed, and the event list padded **in numpy** to a
multiple of 128 with zero-amount events pointed at slot 0.  The counter
tensor is updated in place — ``csrc/wear_update.cu`` on CUDA,
``wear_update_plain`` (``index_add_``) on the CPU.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, count_launch

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]


def wear_update_plain(wear: torch.Tensor, ids: torch.Tensor,
                      amount: torch.Tensor) -> torch.Tensor:
    return wear.index_add_(0, ids.long(), amount)


def _launch(wear, ids, amount) -> torch.Tensor:
    if wear.dtype != torch.int32 or not wear.is_contiguous():
        raise ValueError("wear_update: wear must be contiguous int32")
    for name, t in (("ids", ids), ("amount", amount)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous() \
                or t.device != wear.device or t.shape != ids.shape:
            raise ValueError(f"wear_update: {name} must be a contiguous "
                             f"int32 vector on {wear.device} shaped like ids")
    if ids.shape[0] == 0:               # nothing to launch, nothing counted
        return wear
    fn = _build.function("wear_update", _ARGTYPES)
    err = fn(wear.data_ptr(), ids.data_ptr(), amount.data_ptr(),
             ids.shape[0], _build.current_stream(wear.device.index))
    _build.check(err, "wear_update")
    count_launch("wear_update")
    return wear


def wear_update_events(wear: torch.Tensor, ids: torch.Tensor,
                       amount: torch.Tensor) -> torch.Tensor:
    """Kernel dispatch over an already-normalised int32 event list."""
    if wear.device.type == "cpu":
        return wear_update_plain(wear, ids, amount)
    if wear.device.type != "cuda":
        raise ValueError(f"wear_update: unsupported device {wear.device}")
    return _launch(wear, ids, amount)


def wear_update(wear: torch.Tensor, slot_ids, amount=None, *,
                valid=None) -> torch.Tensor:
    """wear[slot_ids[i]] += amount[i] in place (duplicates accumulate);
    returns ``wear``.  ``amount`` defaults to one write per event."""
    ids_np = np.clip(np.asarray(slot_ids, np.int64).reshape(-1), 0,
                     wear.shape[0] - 1)
    if ids_np.size == 0:
        return wear
    amt_np = (np.ones(ids_np.shape, np.int64) if amount is None
              else np.broadcast_to(np.asarray(amount, np.int64).reshape(-1),
                                   ids_np.shape).copy())
    if valid is not None:
        amt_np[~np.asarray(valid).reshape(-1)] = 0
    kpad = (-ids_np.size) % 128
    if kpad:
        ids_np = np.concatenate([ids_np, np.zeros(kpad, np.int64)])
        amt_np = np.concatenate([amt_np, np.zeros(kpad, np.int64)])
    ids = torch.from_numpy(ids_np.astype(np.int32)).to(wear.device)
    amt = torch.from_numpy(amt_np.astype(np.int32)).to(wear.device)
    return wear_update_events(wear, ids, amt)
