"""Write-history based future-pattern prediction (paper Sec. 3.2) — the
torch twin of ``repro.core.predictor``.

Each page keeps its last ``WINDOW_LEN`` WD observations as a bitfield in
one uint8 (bit 0 = latest pass).  Popcount >= HI_THRESH predicts
WD_FREQ_H, >= LO_THRESH WD_FREQ_L, else UN_WD; the Reverse rule forces
WD_FREQ_H on an all-WD K_LEN suffix and UN_WD on an all-cold one.
``is_reverse`` says where that rule overrode the window majority, and
``predict_trace`` runs the predictor along a WD trace and scores it.
"""
from __future__ import annotations

import torch

# future-state codes
UN_WD = 0
WD_FREQ_L = 1
WD_FREQ_H = 2

WINDOW_LEN = 8
K_LEN = 3
HI_THRESH = 6
LO_THRESH = 2


def push_history(hist: torch.Tensor, wd_bit: torch.Tensor,
                 window_len: int = WINDOW_LEN) -> torch.Tensor:
    """Shift a new WD observation (0/1) into the per-page history word
    (in the history's own dtype, masked to ``window_len`` bits)."""
    mask = (1 << window_len) - 1
    return ((hist << 1) | wd_bit.to(hist.dtype)) & mask


def popcount8(x: torch.Tensor) -> torch.Tensor:
    """Popcount of <=16-bit values via SWAR bit manipulation (int32)."""
    x = x.to(torch.int32)
    x = x - ((x >> 1) & 0x5555)
    x = (x & 0x3333) + ((x >> 2) & 0x3333)
    x = (x + (x >> 4)) & 0x0F0F
    x = (x + (x >> 8)) & 0x001F
    return x


def predict_future(hist: torch.Tensor, *, window_len: int = WINDOW_LEN,
                   k_len: int = K_LEN, hi_thresh: int = HI_THRESH,
                   lo_thresh: int = LO_THRESH) -> torch.Tensor:
    """int8 future WD state per page from uint8 history bitfields."""
    h = hist.to(torch.int32)
    ones = popcount8(h & ((1 << window_len) - 1))
    base = torch.where(ones >= hi_thresh, WD_FREQ_H,
                       torch.where(ones >= lo_thresh, WD_FREQ_L, UN_WD))
    k_mask = (1 << k_len) - 1
    suffix = h & k_mask
    out = torch.where(suffix == k_mask, WD_FREQ_H, base)
    out = torch.where(suffix == 0, UN_WD, out)
    return out.to(torch.int8)


def is_reverse(hist: torch.Tensor, *, window_len: int = WINDOW_LEN,
               k_len: int = K_LEN, hi_thresh: int = HI_THRESH,
               lo_thresh: int = LO_THRESH) -> torch.Tensor:
    """True where the Reverse rule overrode the whole-window majority (an
    all-WD suffix under a non-WD majority, or the reverse)."""
    h = hist.to(torch.int32)
    ones = popcount8(h & ((1 << window_len) - 1))
    majority_wd = 2 * ones >= window_len
    k_mask = (1 << k_len) - 1
    suffix = h & k_mask
    return ((suffix == k_mask) & ~majority_wd) | \
        ((suffix == 0) & majority_wd)


def predict_trace(wd_trace: torch.Tensor, *, window_len: int = WINDOW_LEN,
                  k_len: int = K_LEN, horizon: int = 1
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the predictor along a [T, n_pages] WD 0/1 trace (a loop over
    T, ``lax.scan`` in the JAX package).  Returns (predictions [T,
    n_pages] int8, float32 accuracy): the prediction at t is scored
    against the WD state at t + ``horizon`` (WD_FREQ_{H,L} predicts 1,
    UN_WD 0), over the steps after the window's warm-up."""
    T = wd_trace.shape[0]
    # the history word holds window_len bits: uint8 up to 8, else int32
    # (the JAX package's uint16; the masked values are the same)
    hdt = torch.uint8 if window_len <= 8 else torch.int32
    hist = torch.zeros(wd_trace.shape[1], dtype=hdt,
                       device=wd_trace.device)
    preds = []
    for t in range(T):
        hist = push_history(hist, wd_trace[t], window_len)
        preds.append(predict_future(hist, window_len=window_len,
                                    k_len=k_len))
    preds = (torch.stack(preds) if preds else
             torch.zeros(wd_trace.shape, dtype=torch.int8,
                         device=wd_trace.device))
    if T <= horizon + window_len:
        return preds, torch.tensor(0.0, dtype=torch.float32)
    pred_bin = (preds[window_len:T - horizon] != UN_WD).to(torch.int32)
    actual = wd_trace[window_len + horizon:].to(torch.int32)
    hits = (pred_bin == actual).to(torch.float32).sum()
    # the mean as XLA takes it: the float32 sum times float32(1 / n)
    return preds, hits * torch.tensor(1.0 / actual.numel(),
                                      dtype=torch.float32)
