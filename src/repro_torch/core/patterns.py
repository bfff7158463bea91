"""Memory-pattern classification (paper Sec. 3) over per-page counter
tensors — the torch twin of ``repro.core.patterns``.

  * WD (Write-Domain):  2 * writes >= reads   (and the page was touched)
  * RD (Read-Domain):   reads > 2 * writes    (and the page was touched)
  * cold:               untouched in the sampling pass
  * hot:                access_count > samples / 2
  * reuse classes:      THRASHING (small, stable reuse interval),
                        FREQ_TOUCHED, RARELY_TOUCHED
"""
from __future__ import annotations

import torch

# --- pattern codes (per-pass page state) ------------------------------------
COLD = 0
RD = 1
WD = 2

# --- reuse classes -----------------------------------------------------------
RARELY_TOUCHED = 0
FREQ_TOUCHED = 1
THRASHING = 2

WRITE_WEIGHT = 2  # empirical value from the paper (footnote 1)


def classify_wd(reads: torch.Tensor, writes: torch.Tensor) -> torch.Tensor:
    """Per-page int8 code in {COLD, RD, WD} for one sampling pass."""
    touched = (reads + writes) > 0
    code = torch.where(WRITE_WEIGHT * writes >= reads, WD, RD)
    return torch.where(touched, code, COLD).to(torch.int8)


def classify_hot(access_count: torch.Tensor, pass_samples) -> torch.Tensor:
    """Hot iff the page was seen accessed in most samplings of the pass."""
    return access_count * 2 > pass_samples


def hotness_score(access_count: torch.Tensor,
                  writes: torch.Tensor) -> torch.Tensor:
    """float32 hotness-list ranking key: access frequency plus half the
    (capped) write count, so a WD page sorts above an equally frequent
    RD one."""
    a = access_count.float()
    return a + 0.5 * torch.minimum(writes.float(), a)


def classify_reuse(intv_cnt: torch.Tensor, intv_sum: torch.Tensor,
                   intv_sqsum: torch.Tensor, pass_samples: torch.Tensor, *,
                   thrash_mean_max: float = 4.0, thrash_std_max: float = 2.0,
                   rare_count_frac: float = 0.05) -> torch.Tensor:
    """int8 reuse class per page from the online interval stats (float32
    arithmetic, as the JAX module)."""
    cnt = torch.clamp(intv_cnt, min=1)
    mean = intv_sum / cnt
    var = torch.clamp(intv_sqsum / cnt - mean * mean, min=0.0)
    std = torch.sqrt(var)
    rare_bar = torch.clamp(rare_count_frac * pass_samples.float(), min=1.0)
    rare = intv_cnt < rare_bar
    thrash = (~rare) & (mean <= thrash_mean_max) & (std <= thrash_std_max)
    out = torch.where(thrash, THRASHING, FREQ_TOUCHED)
    return torch.where(rare, RARELY_TOUCHED, out).to(torch.int8)
