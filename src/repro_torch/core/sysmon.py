"""SysMon — inner-runtime memory-pattern profiling (paper Sec. 4.2), the
torch twin of ``repro.core.sysmon``.

The state is a tuple of small int32/uint8 tensors that stays on the
device: the serving engine's fused decode dispatch records every inner
step's page touches (block-table prefix reads, the tail-page KV append)
through the ``touch_update`` kernel without any host round trip, and
only the pass boundary (``end_pass``) hands a classification to the
host-side planner.  On the card that boundary's sweep — WD/RD/COLD, the
history shift and the future-state prediction — is one launch of kernel
K7 (``sysmon_pass``); on CPU tensors it is the tensor composition the
JAX runtime uses.  Algorithm 1 (bank/slab frequency tables) folds each
recorded access through the page's color maps.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.hotness_update import sysmon_pass, touch_update

from . import patterns, predictor

_I32 = torch.int32


class SysmonState(NamedTuple):
    """Per-page counters for the current sampling pass + persistent
    history.  Shapes [n_pages] unless noted; int32 except ``hist``
    (uint8)."""

    reads: torch.Tensor          # reads this pass
    writes: torch.Tensor         # writes this pass
    access_count: torch.Tensor   # samplings in which the page was touched
    hist: torch.Tensor           # uint8 WD history window bitfield
    last_access: torch.Tensor    # sampling idx of last touch (-1 = never)
    intv_cnt: torch.Tensor       # observed reuse intervals
    intv_sum: torch.Tensor       # sum of interval lengths
    intv_sqsum: torch.Tensor     # sum of squared interval lengths
    bank_freq: torch.Tensor      # [n_banks] — Algorithm 1
    slab_freq: torch.Tensor      # [n_slabs] — Algorithm 1
    page_bank: torch.Tensor      # page -> bank map
    page_slab: torch.Tensor      # page -> slab class map
    sample_idx: torch.Tensor     # scalar — sampling counter within the pass

    @property
    def n_pages(self) -> int:
        return self.reads.shape[0]


class PassSummary(NamedTuple):
    """Classification produced at a pass boundary (inputs to placement)."""

    wd_code: torch.Tensor      # int8 {COLD, RD, WD}
    hot: torch.Tensor          # bool
    hotness: torch.Tensor      # float32 ranking key
    reuse_class: torch.Tensor  # int8 {RARELY, FREQ, THRASHING}
    future: torch.Tensor       # int8 {UN_WD, WD_FREQ_L, WD_FREQ_H}
    reads: torch.Tensor        # int32 raw counters
    writes: torch.Tensor
    bank_freq: torch.Tensor
    slab_freq: torch.Tensor

    def numpy(self) -> "PassSummary":
        """The same summary with numpy leaves (one device-to-host copy per
        field, nine in all), the form
        the host-side placement planner consumes."""
        return PassSummary(*[f.cpu().numpy() for f in self])


def init(n_pages: int, n_banks: int, n_slabs: int, *,
         device: str | torch.device,
         page_bank: torch.Tensor | None = None,
         page_slab: torch.Tensor | None = None) -> SysmonState:
    ar = torch.arange(n_pages, dtype=_I32, device=device)
    if page_bank is None:
        page_bank = ar % n_banks
    if page_slab is None:
        page_slab = (ar // max(n_banks, 1)) % n_slabs

    def z():
        return torch.zeros(n_pages, dtype=_I32, device=device)

    return SysmonState(
        reads=z(), writes=z(), access_count=z(),
        hist=torch.zeros(n_pages, dtype=torch.uint8, device=device),
        last_access=torch.full((n_pages,), -1, dtype=_I32, device=device),
        intv_cnt=z(), intv_sum=z(), intv_sqsum=z(),
        bank_freq=torch.zeros(n_banks, dtype=_I32, device=device),
        slab_freq=torch.zeros(n_slabs, dtype=_I32, device=device),
        page_bank=page_bank.to(device=device, dtype=_I32),
        page_slab=page_slab.to(device=device, dtype=_I32),
        sample_idx=torch.zeros((), dtype=_I32, device=device),
    )


def record(state: SysmonState, page_ids: torch.Tensor, *,
           is_write=False, valid: torch.Tensor | None = None) -> SysmonState:
    """Record one sampling's worth of page touches.

    page_ids: int [k] pages touched this sampling (may repeat);
    is_write: bool or bool [k]; valid: optional bool [k] mask for padded
    id lists."""
    d_reads, d_writes, touched_i = touch_update(state.n_pages, page_ids,
                                                is_write, valid)
    return _apply_sampling(state, d_reads, d_writes, touched_i)


def record_dense(state: SysmonState, d_reads: torch.Tensor,
                 d_writes: torch.Tensor) -> SysmonState:
    """Record a bulk sequential access burst (a prefill dispatch) as ONE
    sampling.  ``d_reads``/``d_writes`` are dense int [n_pages] event
    totals: the raw ``reads``/``writes``/``bank_freq``/``slab_freq``
    match replaying the burst token by token, but ``access_count``
    advances by at most 1 and ``sample_idx`` by exactly 1, so the next
    pass sees one streaming touch and ranks the pages sequential and
    cold (paper Sec. 4.2)."""
    d_reads = d_reads.to(_I32)
    d_writes = d_writes.to(_I32)
    touched_i = ((d_reads + d_writes) > 0).to(_I32)
    return _apply_sampling(state, d_reads, d_writes, touched_i)


def _apply_sampling(state: SysmonState, d_reads: torch.Tensor,
                    d_writes: torch.Tensor, touched_i: torch.Tensor
                    ) -> SysmonState:
    """Fold one sampling's dense per-page increments into the state."""
    touched = touched_i > 0
    now = state.sample_idx
    seen_before = state.last_access >= 0
    gap = now - state.last_access
    upd = touched & seen_before
    events = d_reads + d_writes
    return state._replace(
        reads=state.reads + d_reads,
        writes=state.writes + d_writes,
        # samplings in which the page was touched (touched dedupes)
        access_count=state.access_count + touched_i,
        last_access=torch.where(touched, now, state.last_access),
        intv_cnt=state.intv_cnt + upd.to(_I32),
        intv_sum=state.intv_sum + torch.where(upd, gap, 0),
        intv_sqsum=state.intv_sqsum + torch.where(upd, gap * gap, 0),
        bank_freq=state.bank_freq.index_add(0, state.page_bank, events),
        slab_freq=state.slab_freq.index_add(0, state.page_slab, events),
        sample_idx=state.sample_idx + 1,
    )


def end_pass(state: SysmonState) -> tuple[SysmonState, PassSummary]:
    """Close a sampling pass: classify, push WD history, reset counters."""
    if state.reads.device.type == "cuda":
        # one K7 launch for (wd_code, hist, future); hist stays uint8 in
        # the state
        wd32, hist32, fut32 = sysmon_pass(state.reads, state.writes,
                                          state.hist.to(_I32))
        wd_code = wd32.to(torch.int8)
        hist = hist32.to(torch.uint8)
        future = fut32.to(torch.int8)
    else:
        wd_code = patterns.classify_wd(state.reads, state.writes)
        wd_bit = (wd_code == patterns.WD).to(torch.uint8)
        hist = predictor.push_history(state.hist, wd_bit)
        future = predictor.predict_future(hist)
    summary = PassSummary(
        wd_code=wd_code,
        hot=patterns.classify_hot(state.access_count, state.sample_idx),
        hotness=patterns.hotness_score(state.access_count, state.writes),
        reuse_class=patterns.classify_reuse(
            state.intv_cnt, state.intv_sum, state.intv_sqsum,
            state.sample_idx),
        future=future,
        reads=state.reads, writes=state.writes,
        bank_freq=state.bank_freq, slab_freq=state.slab_freq,
    )
    z = torch.zeros_like(state.reads)
    new_state = state._replace(
        reads=z, writes=z, access_count=z, hist=hist,
        last_access=torch.full_like(state.last_access, -1),
        intv_cnt=z, intv_sum=z, intv_sqsum=z,
        bank_freq=torch.zeros_like(state.bank_freq),
        slab_freq=torch.zeros_like(state.slab_freq),
        sample_idx=torch.zeros_like(state.sample_idx),
    )
    return new_state, summary


def summary_metrics(summary: PassSummary) -> dict[str, int]:
    """Pass classification mix as plain-int gauges."""
    wd = np.asarray(summary.wd_code)
    return {
        "hot_pages": int(np.asarray(summary.hot).sum()),
        "wd_pages": int((wd == patterns.WD).sum()),
        "rd_pages": int((wd == patterns.RD).sum()),
        "cold_pages": int((wd == patterns.COLD).sum()),
    }


def remap(state: SysmonState, page_ids: torch.Tensor,
          new_bank: torch.Tensor, new_slab: torch.Tensor) -> SysmonState:
    """Update page->bank/slab maps after the migration engine moves
    pages."""
    idx = page_ids.long()
    page_bank = state.page_bank.clone()
    page_slab = state.page_slab.clone()
    page_bank[idx] = new_bank.to(_I32)
    page_slab[idx] = new_slab.to(_I32)
    return state._replace(page_bank=page_bank, page_slab=page_slab)
