"""Bucketed packed prefill: the serving engine's prompt front door (torch
twin of ``repro.serving.prefill``).

Without it the engine replays every prompt token through the fused
decode loop, one inner step each.  With ``ServeConfig(prefill=True)`` the
newly admitted prompts are ingested in **one dispatch per pow2 bucket**:

  * **pow2 buckets** — a prompt is padded to the smallest covering
    power-of-two bucket (``bucket_for``);
  * **packing** — short prompts are concatenated into one bucket row in
    admission order (``pack_prompts``).  Segment isolation is structural:
    each packed position attends through a *per-row block table* that
    lists only its own segment's KV pages, and the causal mask is the
    ``lengths`` mask;
  * **one dispatch** — every packed position's K/V lands in the pools
    positionally (one ``qkv_rope_append`` of all L rows per layer, with
    the qk-norm and RoPE; padding rows carry an out-of-range slot and are
    dropped), the attention is K1's prefill body with one row per
    position (``paged_attention_prefill_pooled``, or
    ``paged_attention_prefill_dual_pooled`` when prompt pages sit in the
    pinned-host tier: each segment's pages are read once for all of its
    rows), and the first sampled token of every segment comes back with
    the dispatch.

The per-layer op sequence mirrors the decode step's (same append, same
masked attention, same projections and FFN), so a position's output is
the decode step's at that position up to the float summation order of
the dense math, which runs on the bucket's L rows, and of the attention
(the prefill body sums in another order than the decode body).  The engine reports
the burst to SysMon as one ``record_dense`` streaming sampling with the
exact replay totals (``replay_page_counts``), so the next memos pass sees
a sequential, cold write burst.  PyTorch runs eagerly: there is nothing
to compile ahead of time.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.kernels.paged_attention import (
    paged_attention_prefill_dual_pooled, paged_attention_prefill_pooled)
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import rope_append
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

# smallest bucket and most prompts packed into one bucket row (the JAX
# ``ServeConfig`` defaults, the only values in use)
PREFILL_MIN_BUCKET = 16
PREFILL_MAX_SEGMENTS = 4


# =============================================================================
# buckets + packing (host policy)
# =============================================================================

def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


def bucket_for(n: int, min_bucket: int, max_bucket: int) -> int:
    """Smallest covering pow2 bucket for a prompt of ``n`` tokens,
    floored at ``min_bucket``; ValueError past ``max_bucket``."""
    if n > max_bucket:
        raise ValueError(
            f"prompt of {n} tokens exceeds the largest prefill bucket "
            f"({max_bucket}); raise prefill_max_bucket / max_pages_per_seq "
            f"or shorten the prompt")
    return max(next_pow2(n), min_bucket)


def bucket_list(min_bucket: int, max_bucket: int) -> list[int]:
    """Every pow2 bucket in [min_bucket, max_bucket]."""
    out = []
    b = next_pow2(min_bucket)
    while b <= max_bucket:
        out.append(b)
        b *= 2
    return out


@dataclass
class PackedGroup:
    """One prefill dispatch: segments packed into a single bucket row."""
    bucket: int
    requests: list = field(default_factory=list)

    @property
    def total_tokens(self) -> int:
        return sum(len(r.prompt) for r in self.requests)


def pack_prompts(reqs: list, *, min_bucket: int, max_bucket: int,
                 pack: bool = True, max_segments: int = 4
                 ) -> list[PackedGroup]:
    """Greedy packing in admission order: prompts coalesce into one group
    while the packed total fits ``max_bucket`` and the segment budget
    holds; the group's bucket is the smallest pow2 covering its total."""
    groups: list[PackedGroup] = []
    i = 0
    while i < len(reqs):
        total = len(reqs[i].prompt)
        bucket_for(total, min_bucket, max_bucket)   # raises past the cap
        members = [reqs[i]]
        i += 1
        if pack:
            while (i < len(reqs) and len(members) < max_segments
                   and total + len(reqs[i].prompt) <= max_bucket):
                members.append(reqs[i])
                total += len(reqs[i].prompt)
                i += 1
        groups.append(PackedGroup(
            bucket=max(next_pow2(total), min_bucket), requests=members))
    return groups


def replay_page_counts(prompt_lens: list[int], page_tables: np.ndarray,
                       page: int, n_pages: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Per-logical-page (reads, writes) totals of a packed prefill, equal
    to the prompt-replay stream's: replaying an ``Lp``-token prompt reads
    segment page ``j`` once per step whose prefix covers it
    (``Lp - j*page``) and writes it once per step whose tail lands on it
    (``min(page, Lp - j*page)``)."""
    reads = np.zeros(n_pages, np.int64)
    writes = np.zeros(n_pages, np.int64)
    for si, lp in enumerate(prompt_lens):
        for j in range((lp - 1) // page + 1):
            pid = int(page_tables[si, j])
            reads[pid] += lp - j * page
            writes[pid] += min(page, lp - j * page)
    return reads, writes


# =============================================================================
# the prefill dispatches
# =============================================================================

class PrefillRunner:
    """Bucket policy plus the two dispatch bodies (tier-0 pool only, and
    the dual-pool one for prompt pages in the pinned-host tier)."""

    def __init__(self, engine):
        self.eng = engine
        scfg = engine.scfg
        cap = next_pow2(scfg.max_pages_per_seq * scfg.page_size)
        self.min_bucket = PREFILL_MIN_BUCKET
        self.max_bucket = min(next_pow2(scfg.prefill_max_bucket)
                              if scfg.prefill_max_bucket is not None
                              else cap, cap)
        self.max_segments = PREFILL_MAX_SEGMENTS

    def n_table_pages(self, bucket: int) -> int:
        """Per-row block-table width: the pages covering the bucket."""
        page = self.eng.scfg.page_size
        return (bucket + page - 1) // page

    # -- the layer stack ------------------------------------------------------
    def _layers(self, tokens: torch.Tensor, local_pos: torch.Tensor,
                lengths: torch.Tensor, seg_last: torch.Tensor, attend):
        """The decode step's layer stack over the bucket's L positions as
        one sequence [1, L, d].  ``attend(l, qkv)`` gets layer ``l``'s raw
        projections with their qk-norm weights and RoPE tables — the first
        seven arguments of ``attention.rope_append`` (q [L, Hq, D], k/v
        [L, Hkv, D], cos/sin [L, D/2]) — stores its K/V and returns the
        paged attention [L, Hkv, G, D].  Returns (first sampled token [S],
        logits [S, Vp]) at each segment's last position, and the expert
        counts int32 [E] of the prompt rows summed over the layers
        (``lengths > 0``: padding rows are routed but not counted), or
        None for a dense FFN."""
        eng = self.eng
        cfg, params = eng.cfg, eng.params
        n = tokens.shape[0]
        h = T.embed_in(params, cfg, tokens.long()[None, :])
        cos, sin = L.rope_angles(local_pos[None, :], cfg.head_dim,
                                 cfg.rope_theta)
        cos, sin = cos[0], sin[0]
        valid = (lengths > 0)[None, :]
        counts_acc = None
        for l, lp in enumerate(params["layers"]):
            x = L.rms_norm(h, lp["ln1"], eps=cfg.norm_eps,
                           gemma_style=cfg.gemma_norm)
            ap = lp["attn"]
            q, k, v = attn_mod.project_raw(ap, x)
            out = attend(l, (q[0], k[0], v[0], ap.get("q_norm"),
                             ap.get("k_norm"), cos, sin))
            wo = lp["attn"]["wo"]
            h = h + (out.reshape(n, -1) @ wo.reshape(-1, wo.shape[-1]))[None]
            h, counts = T.ffn_block(lp, cfg, h, valid=valid)
            if counts is not None:
                counts_acc = counts if counts_acc is None \
                    else counts_acc + counts
        h = L.rms_norm(h[:, seg_last.long()], params["final_norm"],
                       eps=cfg.norm_eps, gemma_style=cfg.gemma_norm)
        seg_logits = T.logits_out(params, cfg, h)[0]
        first = torch.argmax(seg_logits[:, :cfg.vocab], dim=-1).to(
            torch.int32)
        return first, seg_logits, counts_acc

    def _core_plain(self, tokens, local_pos, row_tables, lengths,
                    write_slot, write_off, seg_last):
        """One packed prefill over the tier-0 pool.  tokens/local_pos [L]
        int32 (padding rows: pos 0, length 0); row_tables [L, Pp] tier-0
        slots of the row's own segment; lengths [L] causal prefix;
        write_slot [L] the position's slot (out of range for padding);
        seg_last [S] each segment's last row."""
        eng = self.eng
        pool = eng.kv.store.fast_pool

        def attend(l, qkv):
            q = rope_append(*qkv, pool[:, l], None, write_slot, None,
                                write_off)
            return paged_attention_prefill_pooled(
                q, *eng.kv.layer_pools(l), row_tables, lengths)
        return self._layers(tokens, local_pos, lengths, seg_last, attend)

    def _core_pinned(self, tokens, local_pos, row_tables, pool_sel, lengths,
                     write_slot, write_sel, write_off, seg_last, remap):
        """Dual-pool packed prefill (mirrors the decode's
        ``_decode_core_pinned``): table entries hold each page's slot in
        its own pool — pinned logical slots translate through ``remap``
        here — and each position's K/V lands in whichever pool owns its
        page, the other pool's index driven out of range.  Wear and
        checksums of the pinned writes are charged by the engine at the
        boundary."""
        eng = self.eng
        store = eng.kv.store
        fast = store.fast_pool
        pin = store.pools[eng.pinned_tier].data
        n_fast, n_pin = fast.shape[0], pin.shape[0]
        row_tables = torch.where(
            pool_sel > 0, remap[row_tables.clamp(0, n_pin - 1).long()],
            row_tables).to(torch.int32).contiguous()
        wsel = write_sel > 0
        wslot = torch.where(wsel, remap[write_slot.clamp(0, n_pin - 1)
                                        .long()], write_slot)
        f_idx = torch.where(wsel, n_fast, wslot).to(torch.int32)
        p_idx = torch.where(wsel, wslot, n_pin).to(torch.int32)

        def attend(l, qkv):
            q = rope_append(*qkv, fast[:, l], pin[:, l], f_idx, p_idx,
                                write_off)
            return paged_attention_prefill_dual_pooled(
                q, fast[:, l, 0], fast[:, l, 1], pin[:, l, 0], pin[:, l, 1],
                row_tables, pool_sel, lengths)
        return self._layers(tokens, local_pos, lengths, seg_last, attend)

    # -- host-side argument assembly -----------------------------------------
    def build_args(self, group: PackedGroup, block_tables: np.ndarray,
                   pool_sel: np.ndarray | None) -> dict[str, np.ndarray]:
        """Expand a packed group's per-segment tables ([S, Pp], and
        ``pool_sel`` on the dual-pool path) into the per-position arrays
        the dispatch consumes."""
        eng = self.eng
        page = eng.scfg.page_size
        Lb = group.bucket
        Pp = self.n_table_pages(Lb)
        n_fast = eng.kv.store.fast_pool.shape[0]
        tokens = np.zeros(Lb, np.int32)
        local_pos = np.zeros(Lb, np.int32)
        lengths = np.zeros(Lb, np.int32)
        # padding rows write out of range in both pools: slot n_fast with
        # sel 0 is dropped by the tier-0 pool and maps to n_pin in the
        # pinned one
        write_slot = np.full(Lb, n_fast, np.int32)
        write_sel = np.zeros(Lb, np.int32)
        write_off = np.zeros(Lb, np.int32)
        row_tables = np.zeros((Lb, Pp), np.int32)
        row_sel = np.zeros((Lb, Pp), np.int32)
        seg_last = np.zeros(len(group.requests), np.int32)
        off = 0
        for si, r in enumerate(group.requests):
            lp = len(r.prompt)
            sl = slice(off, off + lp)
            tokens[sl] = r.prompt
            pos = np.arange(lp, dtype=np.int32)
            local_pos[sl] = pos
            lengths[sl] = pos + 1
            row_tables[sl] = block_tables[si]
            if pool_sel is not None:
                row_sel[sl] = pool_sel[si]
                write_sel[sl] = pool_sel[si, pos // page]
            write_slot[sl] = block_tables[si, pos // page]
            write_off[sl] = pos % page
            seg_last[si] = off + lp - 1
            off += lp
        return dict(tokens=tokens, local_pos=local_pos, lengths=lengths,
                    write_slot=write_slot, write_sel=write_sel,
                    write_off=write_off, row_tables=row_tables,
                    row_sel=row_sel, seg_last=seg_last)
