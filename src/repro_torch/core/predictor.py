"""Write-history based future-pattern prediction (paper Sec. 3.2) — the
torch twin of ``repro.core.predictor``.

Each page keeps its last ``WINDOW_LEN`` WD observations as a bitfield in
one uint8 (bit 0 = latest pass).  Popcount >= HI_THRESH predicts
WD_FREQ_H, >= LO_THRESH WD_FREQ_L, else UN_WD; the Reverse rule forces
WD_FREQ_H on an all-WD K_LEN suffix and UN_WD on an all-cold one.
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
