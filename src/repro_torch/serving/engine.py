"""Paged serving engine: continuous batching + memos-managed KV tiering
(torch twin of ``repro.serving.engine``).

The steady state is a **fused multi-token decode dispatch**: K inner
decode steps run back to back on the device — the JAX ``lax.scan``
becomes a Python loop that only enqueues work.  Greedy sampling (argmax)
happens on the device so each sampled token feeds the next inner step,
SysMon's read/write records (the ``touch_update`` kernel) and the
tier-0 page-write counters stay on the device, and the host reads the
[K, B] token block (and the page-write counters) once per dispatch.
The KV pool is one tensor updated in place by every inner step.

Host-side ``step()`` runs only at dispatch boundaries, in the JAX
engine's order: admit/resume requests, provision tail pages for the
next K positions (shrinking K, then preempting, under HBM pressure),
dispatch, charge accesses, retire finished sequences, and run the memos
pass (plan + migrate + wear/energy snapshot) between dispatches.  With
``ServeConfig(overlap_plan=True)`` the pass's plan runs on a worker
thread across the *next* dispatch and commits at the following boundary
(``core/memos.py``); the pages a commit demoted out from under running
sequences are promoted back before the next snapshot.

``ServeConfig(reference=True)`` keeps the K=1 path — host argmax and
standalone per-step SysMon records — as the parity oracle for the fused
dispatch.

**Dual-pool serving.**  When the deepest tier is a pinned-host pool (the
paper's byte-addressable NVM), its pages are served in place: the block
tables carry each page's slot in its own pool plus a per-page pool
select, the paged-attention kernel's dual-pool variant reads pinned
pages through their mapped device address, and the new token's K/V
lands in whichever pool holds the tail page (``qkv_rope_append``, which
also applies the qk-norm and RoPE).  Pinned
tail writes charge the tier's wear counters on the device
(``wear_update``) every inner step; Start-Gap advances earned by the
dispatch run after its K steps — row swaps, remap rotation, wear charge
— and the boundary adopts them into the host trackers, in the JAX
order.  A dispatch whose pages all sit in tier 0 takes the single-pool
path.

**int8 tiers.**  A quantized deepest tier (the lossy soft-NVM medium)
is never served in place, pinned or not: its pages are promoted — and
dequantized on the card — before they are attended, and demotions into
it are quantized on the card by kernel K6.

**Prefill.**  With ``ServeConfig(prefill=True)`` every newly admitted
request ingests its whole prompt in one bucketed, packed dispatch
(``serving/prefill.py``) and joins the decode batch with its first token
sampled; SysMon sees the burst as one streaming sampling.  Without it
the prompt is replayed through the decode loop one token per step.

**Faults.**  While the global fault injector is armed, every step drains
the store's quarantine log (failing the owners of lost pages with a
``PageCorruptionError``), re-verifies the checksums of every pinned page
the dispatch is about to serve, refreshes the checksums of pinned rows
the dispatch appended to, and ticks the injector last, so each
corruption meets a detection point before the next serve.

**QoS.**  ``ServeConfig(qos=QoSConfig(...))`` (``repro_torch.qos``)
gives each request a tenant: its priority orders admission and
preemption, its page weight rides onto its KV pages for the memos
planner, and per-tenant TTFT, e2e and inter-token latency histograms
publish as ``qos.*.<tenant>``.  A power budget makes the memos governor
narrow admission while the NVM's dynamic power is over it.  A bare
``QoSConfig()`` serves exactly as ``qos=None``.

**MoE.**  An MoE arch's FFN routes every row of a step and runs its
experts on kernel ``moe_ffn``; the router's per-expert counts accumulate
on the device and reach ``expert_counts`` (the paper's bank-utilization
histogram) with each dispatch's existing host reads.  Padding rows — the
decode's rows past the batch, a prefill bucket's rows past its prompts —
are routed and computed like the others but not counted.

The KV pool takes the parameters' dtype (bfloat16 weights serve from a
bfloat16 pool).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.core import sysmon as sysmon_mod
from repro_torch.core.hierarchy import MemoryHierarchy
from repro_torch.core.memos import MemosConfig, MemosManager
from repro_torch.core.tiers import NO_SLOT
from repro_torch.device import resolve_device
from repro_torch.faults.errors import CapacityError, PageCorruptionError
from repro_torch.faults.injector import get_injector, note_recovered
from repro_torch.kernels.paged_attention import (paged_attention_dual_pooled,
                                                 paged_attention_pooled)
from repro_torch.kernels.wear_update import wear_update_events
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import rope_append
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.qos import QoSConfig
from repro_torch.serving.kv_cache import SERVE_TIER, PagedKVCache, PagedKVConfig
from repro_torch.serving.prefill import (PackedGroup, PrefillRunner,
                                         pack_prompts, replay_page_counts)
from repro_torch.serving.scheduler import ContinuousBatcher, Request


@dataclass
class ServeConfig:
    page_size: int = 16
    max_batch: int = 4
    fast_slots: int = 48
    slow_slots: int = 512
    # full tier stack; None -> two_tier(fast, slow)
    hierarchy: MemoryHierarchy | None = None
    memos_interval: int = 8
    max_pages_per_seq: int = 64
    memos_enabled: bool = True
    # NVM wear feedback horizon (years); None = telemetry only
    lifetime_horizon_years: float | None = None
    # K: inner decode steps per fused dispatch (the effective K shrinks
    # near sequence ends)
    decode_block: int = 8
    # K=1 path with host-side sampling + standalone SysMon records; the
    # parity oracle of the fused dispatch
    reference: bool = False
    # bucketed packed prefill (serving/prefill.py): newly admitted
    # requests ingest their whole prompt in one pow2-bucket dispatch
    # instead of replaying it through the decode loop; ignored under
    # reference=True (the oracle is prompt replay)
    prefill: bool = False
    # largest bucket (pow2-rounded); None -> covers max_pages_per_seq
    prefill_max_bucket: int | None = None
    # pack several short prompts into one bucket row (segment-isolated)
    prefill_pack: bool = True
    # overlap the memos *plan* phase with the next dispatch on a worker
    # thread (snapshot -> plan -> commit; the pass's migrations commit at
    # the following dispatch boundary, pages dirtied mid-plan degrade to
    # the next pass)
    overlap_plan: bool = False
    # multi-tenant QoS (repro_torch.qos): tenant classes and priorities,
    # page utility weights into memos placement, and the dynamic-power
    # cap.  None, or a bare QoSConfig() with no tenants and no budget,
    # keeps every scheduler and placement decision as without QoS
    qos: QoSConfig | None = None


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` with zero rows appended along dim 0 up to ``rows``."""
    if t.shape[0] == rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0], *t.shape[1:]))])


class PagedServingEngine:
    def __init__(self, cfg: ArchConfig, params: dict, scfg: ServeConfig, *,
                 device: str | torch.device | None = "cuda"):
        if cfg.layout != "attn":
            raise NotImplementedError(
                "the port's paged engine serves attention archs (dense "
                "and MoE)")
        if cfg.input_mode != "tokens":
            # requests are token ids, as in the JAX engine, which embeds
            # {"tokens": ...} only
            raise NotImplementedError(
                f"{cfg.name}: the port's paged engine serves token-input "
                f"archs, not input_mode={cfg.input_mode!r}")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.kv = PagedKVCache(PagedKVConfig(
            n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, page_size=scfg.page_size,
            fast_slots=scfg.fast_slots, slow_slots=scfg.slow_slots,
            dtype=params["embed"].dtype, hierarchy=scfg.hierarchy),
            device=self.device)
        store = self.kv.store
        # dual-pool serving: a pinned-host deepest tier is served and
        # appended in place by the decode — unless it is int8, which
        # cannot absorb token-granular appends: its pages are promoted
        pt = self.kv.pinned_tier
        if pt is not None and store.is_quantized_tier(pt):
            pt = None
        self.pinned_tier = pt
        # in-dispatch Start-Gap: the dual-pool dispatch advances the
        # pinned tier's gap itself once this many pinned writes have
        # accumulated (0 = no leveler or untracked tier: no advances)
        lv = store.leveler_by_tier.get(pt) if pt is not None else None
        self._gap_interval = (lv.interval if lv is not None
                              and store.wear_by_tier.get(pt) is not None
                              and store.pools[pt].data.shape[0] >= 2
                              else 0)
        self.sysmon = sysmon_mod.init(
            self.kv.n_pages, n_banks=store.cfg.n_banks,
            n_slabs=store.cfg.n_slabs, device=self.device)
        qos = scfg.qos
        self.memos = MemosManager(store, MemosConfig(
            interval=scfg.memos_interval, adaptive_interval=False,
            lifetime_horizon_years=scfg.lifetime_horizon_years,
            async_plan=scfg.overlap_plan,
            power_cap_mw=qos.power_budget_mw if qos is not None else None))
        # priority-aware scheduling engages only when tenants exist: a
        # bare QoSConfig() keeps the plain admission code path
        self.batcher = ContinuousBatcher(
            scfg.max_batch,
            priority_aware=bool(qos is not None and qos.tenants))
        self.step_count = 0
        self.tokens_out = 0
        self.rid = 0
        self.last_logits = None     # final inner step's logits, on device
        # expert hotness of an MoE arch: the router's counts of every
        # real row served, added on the host after each dispatch
        self.expert_counts = (np.zeros(cfg.n_experts, np.int64)
                              if cfg.is_moe else None)
        self.prefill_runner = (PrefillRunner(self)
                               if scfg.prefill and not scfg.reference
                               else None)
        # prompt tokens ingested by prefill since the last memos tick: the
        # pass's sampling clock advances by them (replay would have spent
        # that many inner decode steps)
        self._prefill_tokens_pending = 0

    # -- request API -----------------------------------------------------------
    def submit(self, prompt: list[int], max_new: int, *,
               tenant: str | None = None) -> Request:
        cap = self.scfg.max_pages_per_seq * self.scfg.page_size
        if len(prompt) + max_new > cap:
            raise CapacityError(
                f"sequence needs {len(prompt) + max_new} positions but "
                f"max_pages_per_seq*page_size = {cap}")
        if (self.prefill_runner is not None
                and len(prompt) > self.prefill_runner.max_bucket):
            raise CapacityError(
                f"prompt of {len(prompt)} tokens exceeds the largest "
                f"prefill bucket ({self.prefill_runner.max_bucket}); raise "
                f"prefill_max_bucket (or max_pages_per_seq) or split the "
                f"prompt")
        req = Request(self.rid, list(prompt), max_new, arrival=self.step_count)
        req.submit_ts = time.monotonic()
        if tenant is not None:
            req.tenant = tenant
        qos = self.scfg.qos
        if qos is not None:
            spec = qos.spec(tenant)
            req.priority = spec.priority
            req.weight = spec.page_weight
        req.tokens = []          # processed tokens (prompt-consumed + generated)
        req.generated = []
        self.rid += 1
        self.batcher.submit(req)
        return req

    # -- page management ---------------------------------------------------------
    def _servable_mask(self, pids):
        """Pages the dispatch can attend to: tier-0 residents, plus the
        pinned deepest tier's residents on the dual-pool path."""
        if self.pinned_tier is not None:
            return self.kv.servable_mask(pids)
        return self.kv.resident_mask(pids)

    def _ensure_pages(self, req: Request, k: int = 1) -> bool:
        """Provision ``req`` for the next ``k`` decode positions: allocate
        the tail pages covering pos .. pos+k-1 and promote every page the
        dispatch cannot serve where it lies."""
        need = (req.pos + k - 1) // self.scfg.page_size + 1
        while len(req.pages) < need:
            pid = self.kv.new_page(SERVE_TIER)
            if pid is None:
                return False
            req.pages.append(pid)
            if req.weight != 1.0:
                # the tenant's utility weight rides onto the page for the
                # memos planner (demotion resistance, ranking multiplier)
                self.memos.set_page_weight([pid], req.weight)
        return self._promote_all([req])

    def _release_pages(self, req: Request) -> None:
        """Free a retired request's pages, first resetting any tenant
        weight to neutral: a recycled page must not keep its previous
        owner's demotion resistance."""
        if req.weight != 1.0 and req.pages:
            self.memos.set_page_weight(req.pages, 1.0)
        for pid in req.pages:
            self.kv.free_page(pid)
        req.pages = []

    def _promote_all(self, reqs: list[Request]) -> bool:
        """Promote every non-servable page of ``reqs`` in one batched
        migration."""
        pids = [p for req in reqs for p in req.pages]
        if not pids:
            return True
        mask = self._servable_mask(pids)
        if not mask.all():
            cold = [p for p, m in zip(pids, mask) if not m]
            self.memos.engine.migrate_locked(cold, SERVE_TIER)
            mask = self._servable_mask(pids)
        return bool(mask.all())

    def _make_room(self, max_priority: int | None = None) -> bool:
        """Preempt a running sequence (lowest priority first, then the
        most recent; none above ``max_priority``) and eagerly demote its
        tier-0 pages (deepest tier first), so admission is never blocked
        on a lazy memos drain."""
        victim = self.batcher.preempt_lowest(max_priority)
        if victim is None:
            return False
        obs.get_registry().counter(
            "serving.preemptions",
            "running sequences preempted for capacity").inc()
        store = self.kv.store
        for dst in range(store.n_tiers - 1, 0, -1):
            still = [p for p in victim.pages
                     if int(store.tier[p]) == SERVE_TIER]
            if not still:
                break
            self.memos.engine.migrate_optimistic(still, dst)
        return True

    def _fail_request(self, req: Request, err: Exception) -> None:
        self._release_pages(req)
        self.batcher.fail(req, self.step_count, err)
        obs.get_registry().counter(
            "serving.failed_requests",
            "requests retired with a structured error").inc()

    # -- fault handling (repro_torch.faults) -----------------------------------
    def _drain_faults(self) -> None:
        """Fail every sequence owning a page the store quarantined since
        the last drain (scrub, promotion pre-flight, pre-dispatch verify):
        the page's bits are lost, so its owner errors cleanly instead of
        ever serving from a corrupt page."""
        store = self.kv.store
        if not store.quarantine_log:
            return
        bad = set(store.quarantine_log)
        store.quarantine_log.clear()
        everyone = (self.batcher.active + list(self.batcher.preempted)
                    + list(self.batcher.waiting))
        for req in everyone:
            hit = sorted(bad.intersection(req.pages))
            if hit:
                self._fail_request(req, PageCorruptionError(
                    f"request {req.rid}: page(s) {hit} lost to media "
                    f"corruption", rid=req.rid, pages=hit))

    def _predispatch_verify(self, active: list[Request]) -> None:
        """Re-verify the checksum of every page this dispatch would serve
        out of the pinned-host pool (tier 0 is trusted media; numpy-host
        pages verify on promotion pre-flight instead).  A mismatch
        quarantines the slot, and the following drain fails the owner
        before it can attend to the bits."""
        pt = self.pinned_tier
        store = self.kv.store
        if pt is None or not store.integrity.enabled:
            return
        slots = {int(store.slot[p]) for r in active for p in r.pages
                 if int(store.tier[p]) == pt
                 and int(store.slot[p]) != NO_SLOT}
        for s in store.integrity.verify(store, pt, sorted(slots)):
            store.quarantine_slot(pt, s, reason="pre-dispatch")

    # -- model compute -------------------------------------------------------------
    def _decode_layers(self, tokens: torch.Tensor, positions: torch.Tensor,
                       attend):
        """The layer stack of one decode step.  ``attend(l, qkv)`` gets
        layer ``l``'s raw projections of the new token with their qk-norm
        weights and RoPE tables — the first seven arguments of
        ``attention.rope_append`` (q [B, Hq, D], k/v [B, Hkv, D], cos/sin
        [B, D/2]) — stores its K/V and returns the paged attention over
        the pools [B, Hkv, G, D].  Returns (logits [B, Vp], expert
        counts int32 [E] summed over the layers, or None for a dense
        FFN).

        The dense math runs on ``max_batch`` rows whatever B is (zero
        rows pad the batch): the card's matmul and reduction kernels pick
        their work split by shape, so a row's bits would otherwise depend
        on how many rows share the dispatch, and the same request could
        decode differently under another schedule.  An MoE FFN routes the
        padding rows too (so every row's bits stay its own) but counts
        only the real rows."""
        cfg = self.cfg
        params = self.params
        B = tokens.shape[0]
        R = max(self.scfg.max_batch, B)
        h = T.embed_in(params, cfg, _pad_rows(tokens.long(), R)[:, None])
        cos, sin = L.rope_angles(_pad_rows(positions, R)[:, None],
                                 cfg.head_dim, cfg.rope_theta)
        cos, sin = cos[:B, 0], sin[:B, 0]
        valid = (torch.arange(R, device=h.device) < B)[:, None]
        counts_acc = None
        for l, lp in enumerate(params["layers"]):
            x = L.rms_norm(h, lp["ln1"], eps=cfg.norm_eps,
                           gemma_style=cfg.gemma_norm)
            ap = lp["attn"]
            q, k, v = attn_mod.project_raw(ap, x)
            out = attend(l, (q[:B, 0], k[:B, 0], v[:B, 0], ap.get("q_norm"),
                             ap.get("k_norm"), cos, sin))
            wo = lp["attn"]["wo"]
            out = _pad_rows(out.reshape(B, -1), R) \
                @ wo.reshape(-1, wo.shape[-1])
            h = h + out[:, None, :]
            h, counts = T.ffn_block(lp, cfg, h, valid=valid)
            if counts is not None:
                counts_acc = counts if counts_acc is None \
                    else counts_acc + counts
        h = L.rms_norm(h, params["final_norm"], eps=cfg.norm_eps,
                       gemma_style=cfg.gemma_norm)
        return T.logits_out(params, cfg, h)[:B, 0], counts_acc

    def _decode_core(self, tokens: torch.Tensor, positions: torch.Tensor,
                     block_tables: torch.Tensor,
                     lengths: torch.Tensor):
        """One decode step for the batch: write the new token's K/V into
        the tier-0 pool (in place) *before* attention, then run the layer
        stack through the paged-attention kernel.  tokens/positions [B];
        block_tables [B, P] int32 tier-0 slots; lengths int32 [B]
        (including the current token).  Returns (logits [B, Vp], expert
        counts or None), as :meth:`_decode_layers`."""
        page = self.scfg.page_size
        pool = self.kv.store.fast_pool
        b_idx = torch.arange(tokens.shape[0], device=tokens.device)
        pos = positions.long()
        f_idx = block_tables[b_idx, pos // page].to(torch.int32)
        off = (pos % page).to(torch.int32)

        def attend(l, qkv):
            q = rope_append(*qkv, pool[:, l], None, f_idx, None, off)
            return paged_attention_pooled(q, *self.kv.layer_pools(l),
                                          block_tables, lengths)
        return self._decode_layers(tokens, positions, attend)

    def _decode_core_pinned(self, tokens: torch.Tensor,
                            positions: torch.Tensor,
                            block_tables: torch.Tensor,
                            pool_sel: torch.Tensor, lengths: torch.Tensor,
                            remap: torch.Tensor):
        """One decode step with the KV split across the tier-0 pool and
        the pinned-host pool: pages are attended wherever they live
        (``paged_attention_dual_pooled``) and the new token's K/V lands in
        whichever pool holds the tail page (``qkv_rope_append``).

        block_tables [B, P] hold each page's slot *in its own pool* — the
        tier-0 slot, or the pinned pool's **logical** slot, translated
        here through ``remap`` (the wear-leveling logical -> physical
        permutation, int32 [n_pin]) before any kernel runs; pool_sel
        [B, P] is 1 for pinned pages.  The pool that does not hold a
        row's tail gets an out-of-range slot, which the append drops, so
        a numeric slot collision between the pools never clobbers a real
        write.  Returns (logits [B, Vp], expert counts or None)."""
        page = self.scfg.page_size
        store = self.kv.store
        fast = store.fast_pool
        pin = store.pools[self.pinned_tier].data
        n_fast, n_pin = fast.shape[0], pin.shape[0]
        sel = pool_sel > 0
        # pinned entries -> physical rows under the current remap (fast
        # entries pass through; the clamp keeps the dead lookup in range)
        block_tables = torch.where(
            sel, remap[block_tables.clamp(0, n_pin - 1).long()],
            block_tables).to(torch.int32).contiguous()
        b_idx = torch.arange(tokens.shape[0], device=tokens.device)
        tailcol = (positions // page).long()
        slot = block_tables[b_idx, tailcol]
        sel_tail = sel[b_idx, tailcol]
        off = (positions % page).to(torch.int32)
        f_idx = torch.where(sel_tail, n_fast, slot).to(torch.int32)
        p_idx = torch.where(sel_tail, slot, n_pin).to(torch.int32)

        def attend(l, qkv):
            q = rope_append(*qkv, fast[:, l], pin[:, l], f_idx, p_idx,
                                off)
            return paged_attention_dual_pooled(
                q, fast[:, l, 0], fast[:, l, 1], pin[:, l, 0], pin[:, l, 1],
                block_tables, pool_sel, lengths)
        return self._decode_layers(tokens, positions, attend)

    @staticmethod
    def _advance_prompt(positions, prompt_buf, prompt_len, sampled, b_idx):
        """The next position, and the next input token — the buffered
        prompt token while replay is still inside the prompt, the freshly
        sampled token once past it."""
        nxt_pos = positions + 1
        prompt_next = prompt_buf[
            b_idx, torch.clamp(nxt_pos, 0, prompt_buf.shape[1] - 1).long()]
        nxt_tok = torch.where(nxt_pos < prompt_len, prompt_next, sampled)
        return nxt_tok, nxt_pos

    def _k_steps(self, tokens, positions, prompt_buf, prompt_len,
                 page_tables, k_steps: int, decode, on_tail=None):
        """K inner decode steps enqueued back to back: ``decode(tokens,
        positions)`` returns one step's logits and expert counts (or
        None), device-side argmax feeds
        the next step, SysMon records and the page-write counters
        accumulate on the device, and ``on_tail(tailcol)`` (if given)
        runs after each step's records.  Returns ([K, B] sampled tokens
        and [n_pages] page writes as numpy — the dispatch's only host
        reads — and the last step's logits on the device).  An MoE arch's
        expert counts add up in the page-write counters' buffer, ride on
        its host read and are added to ``expert_counts``."""
        cfg = self.cfg
        page = self.scfg.page_size
        dev = self.device
        B, P = page_tables.shape
        b_idx = torch.arange(B, device=dev)
        col = torch.arange(P, dtype=torch.int32, device=dev)[None, :]
        ones = torch.ones(B, dtype=torch.int32, device=dev)
        n_pages = self.kv.n_pages
        n_exp = cfg.n_experts if self.expert_counts is not None else 0
        acc = torch.zeros(n_pages + n_exp, dtype=torch.int32, device=dev)
        page_writes, expert_acc = acc[:n_pages], acc[n_pages:]
        sampled_all = torch.empty((k_steps, B), dtype=torch.int32, device=dev)
        logits = None
        for s in range(k_steps):
            logits, counts = decode(tokens, positions)
            if n_exp:
                expert_acc.add_(counts)
            sampled = torch.argmax(logits[:, :cfg.vocab], dim=-1).to(
                torch.int32)
            nxt_tok, nxt_pos = self._advance_prompt(
                positions, prompt_buf, prompt_len, sampled, b_idx)
            # SysMon: one read sampling over the block-table prefix
            # covering the current position, one write sampling on the
            # tail page (the reference path's cadence)
            tailcol = (positions // page).long()
            self.sysmon = sysmon_mod.record(
                self.sysmon, page_tables.reshape(-1), is_write=False,
                valid=(col <= tailcol[:, None]).reshape(-1))
            tails = page_tables[b_idx, tailcol]
            self.sysmon = sysmon_mod.record(self.sysmon, tails,
                                            is_write=True)
            page_writes.index_add_(0, tails.long(), ones)
            if on_tail is not None:
                on_tail(tailcol)
            sampled_all[s] = sampled
            tokens, positions = nxt_tok, nxt_pos
        acc = acc.cpu().numpy()
        if n_exp:
            self.expert_counts += acc[n_pages:]
        return sampled_all.cpu().numpy(), acc[:n_pages], logits

    def _fused_decode(self, tokens, positions, prompt_buf, prompt_len,
                      page_tables, block_tables, k_steps: int):
        """The single-pool fused dispatch: K inner steps over tier-0
        pages.  Returns what :meth:`_k_steps` returns."""
        return self._k_steps(
            tokens, positions, prompt_buf, prompt_len, page_tables, k_steps,
            lambda t, p: self._decode_core(t, p, block_tables, p + 1))

    def _fused_decode_pinned(self, tokens, positions, prompt_buf,
                             prompt_len, page_tables, block_tables, pool_sel,
                             wear, remap, gap: int, pending: int, *,
                             k_steps: int, gap_interval: int):
        """The dual-pool fused dispatch: K inner steps with KV appends
        landing in either pool, and each step's pinned tail write charged
        to its physical row under the carried remap through
        ``wear_update`` (amount 0 for tier-0 tails).  Start-Gap runs after
        the K steps: the loop only accumulates the pinned write count;
        then every advance the dispatch earned swaps physical rows (gap,
        gap+1) of the pinned pool, swaps their two remap entries and
        charges both rows' wear — the JAX order and arithmetic, so gap,
        rotation, remap and pool state match it exactly.  ``wear`` is the
        tracker's device counter tensor, updated in place (None for an
        untracked tier); ``gap_interval`` 0 disables the advances.

        Returns ([K, B] sampled tokens, [n_pages] page writes — numpy —,
        the last logits, wear, the rotated remap, gap, pending, number of
        advances)."""
        dev = self.device
        ppool = self.kv.store.pools[self.pinned_tier]
        n_pin = ppool.data.shape[0]
        b_idx = torch.arange(block_tables.shape[0], device=dev)
        pin_w = torch.zeros((), dtype=torch.int64, device=dev)

        def charge_pinned_tail(tailcol):
            # pinned-tier wear: pinned tails charge their physical row
            tail_pin = pool_sel[b_idx, tailcol].contiguous()
            if wear is not None:
                tail_slot = block_tables[b_idx, tailcol].clamp(0, n_pin - 1)
                wear_update_events(wear, remap[tail_slot.long()].contiguous(),
                                   tail_pin)
            pin_w.add_(tail_pin.sum())

        sampled_np, page_writes, logits = self._k_steps(
            tokens, positions, prompt_buf, prompt_len, page_tables, k_steps,
            lambda t, p: self._decode_core_pinned(t, p, block_tables,
                                                  pool_sel, p + 1, remap),
            on_tail=charge_pinned_tail)
        n_adv = 0
        if gap_interval:
            pending = pending + int(pin_w)
            while pending >= gap_interval:
                # one Start-Gap move, mirroring StartGapLeveler.advance
                nxt = gap + 1
                ppool.scatter([nxt, gap], ppool.gather([gap, nxt]))
                remap = torch.where(remap == gap, nxt,
                                    torch.where(remap == nxt, gap, remap))
                # the swap physically rewrites both rows
                wear_update_events(
                    wear, torch.tensor([gap, nxt], dtype=torch.int32,
                                       device=dev),
                    torch.ones(2, dtype=torch.int32, device=dev))
                gap = 0 if nxt >= n_pin - 1 else nxt
                pending -= gap_interval
                n_adv += 1
        return (sampled_np, page_writes, logits, wear, remap, gap, pending,
                n_adv)

    def _dispatch_pinned(self, args: list, pool_sel: np.ndarray, wear_tr,
                         k: int):
        """One fused dual-pool dispatch, then the boundary adopt: the
        tracker takes the dispatch's wear counters (app writes plus the
        two row rewrites of each advance) and its rotated remap, and the
        leveler its (gap, pending) bookkeeping — counter arithmetic only,
        never row swaps.  Returns (sampled, page_writes, logits)."""
        store = self.kv.store
        pt = self.pinned_tier
        lv = (store.leveler_by_tier.get(pt) if self._gap_interval
              else None)
        (sampled, page_writes, logits, wear, remap, _, pending,
         n_adv) = self._fused_decode_pinned(
            *args, torch.from_numpy(pool_sel).to(self.device),
            None if wear_tr is None else wear_tr.state.wear,
            self._pinned_remap(wear_tr),
            lv.stats.gap if lv is not None else 0,
            lv._pending if lv is not None else 0,
            k_steps=k, gap_interval=self._gap_interval)
        if wear_tr is not None:
            n_pin_w = int(page_writes[store.tier == pt].sum())
            with obs.span("serve.startgap_adopt", advances=n_adv):
                wear_tr.adopt_scan_writes(wear, n_pin_w,
                                          leveling_writes=2 * n_adv)
                if n_adv:
                    wear_tr.adopt_scan_remap(remap)
                if lv is not None:
                    lv.adopt_scan_advances(n_adv, pending)
        return sampled, page_writes, logits

    def _reference_decode(self, tokens, positions, page_tables,
                          block_tables, pool_sel=None, remap=None):
        """The K=1 oracle: one decode step, argmax on the host, and the two
        SysMon samplings recorded as standalone calls.  With ``pool_sel``
        (and the pinned tier's ``remap``) the step is the dual-pool one."""
        page = self.scfg.page_size
        P = page_tables.shape[1]
        B = tokens.shape[0]
        dev = self.device
        if pool_sel is None:
            logits, counts = self._decode_core(
                torch.from_numpy(tokens).to(dev),
                torch.from_numpy(positions).to(dev),
                torch.from_numpy(block_tables).to(dev),
                torch.from_numpy(positions + 1).to(dev))
        else:
            logits, counts = self._decode_core_pinned(
                torch.from_numpy(tokens).to(dev),
                torch.from_numpy(positions).to(dev),
                torch.from_numpy(block_tables).to(dev),
                torch.from_numpy(pool_sel).to(dev),
                torch.from_numpy(positions + 1).to(dev), remap)
        sampled = torch.argmax(logits[:, :self.cfg.vocab], dim=-1).cpu() \
            .numpy().astype(np.int32)[None, :]
        if counts is not None:
            self.expert_counts += counts.cpu().numpy()
        read_valid = np.arange(P)[None, :] <= (positions // page)[:, None]
        self.sysmon = sysmon_mod.record(
            self.sysmon, torch.from_numpy(page_tables.reshape(-1)).to(dev),
            is_write=False,
            valid=torch.from_numpy(read_valid.reshape(-1)).to(dev))
        tails = page_tables[np.arange(B), positions // page]
        self.sysmon = sysmon_mod.record(
            self.sysmon, torch.from_numpy(tails).to(dev), is_write=True)
        page_writes = np.zeros(self.kv.n_pages, np.int64)
        np.add.at(page_writes, tails, 1)
        return sampled, page_writes, logits

    def _page_read_counts(self, positions: np.ndarray,
                          page_tables: np.ndarray, k: int) -> np.ndarray:
        """Per-logical-page read counts of one K-step dispatch: page j of
        a row is read by every inner step whose block-table prefix covers
        it (closed form, no device work)."""
        page = self.scfg.page_size
        P = page_tables.shape[1]
        n_prefix = (positions[:, None] + np.arange(k)[None, :]) // page + 1
        cnt = (n_prefix[:, None, :] > np.arange(P)[None, :, None]).sum(2)
        reads = np.zeros(self.kv.n_pages, np.int64)
        np.add.at(reads, page_tables.reshape(-1), cnt.reshape(-1))
        return reads

    def _pinned_remap(self, wear_tr) -> torch.Tensor:
        """The pinned tier's logical -> physical remap on the device (the
        identity for an untracked tier)."""
        if wear_tr is not None:
            return wear_tr.state.remap
        n_pin = self.kv.store.pools[self.pinned_tier].data.shape[0]
        return torch.arange(n_pin, dtype=torch.int32, device=self.device)

    # -- bucketed packed prefill (serving/prefill.py) ----------------------------
    def _prefill_admitted(self) -> None:
        new = [r for r in self.batcher.active if r.pos == 0]
        if not new:
            return
        pr = self.prefill_runner
        for g in pack_prompts(
                new, min_bucket=pr.min_bucket, max_bucket=pr.max_bucket,
                pack=self.scfg.prefill_pack, max_segments=pr.max_segments):
            self._prefill_group(g)

    def _prefill_group(self, group: PackedGroup) -> None:
        """One packed prefill dispatch: provision every segment's prompt
        pages, run the dispatch, then settle the boundary with the totals
        replaying the prompts would have charged — store accesses, one
        SysMon streaming sampling, pinned wear and checksums — and stamp
        each segment's first token."""
        # provision under pressure: preempt, dropping members that were
        # evicted themselves (they re-enter later with pos still 0), and
        # fail the blocked request when nothing is left to preempt
        while True:
            self._drain_faults()
            segs = [r for r in group.requests
                    if not r.preempted and not r.done]
            blocked = None
            for r in segs:
                if not self._ensure_pages(r, k=len(r.prompt)):
                    blocked = r
                    break
            if blocked is None:
                break
            if not self._make_room():
                self._fail_request(blocked, CapacityError(
                    f"request {blocked.rid}: HBM+host pools exhausted "
                    f"during prefill and no preemption victim remains",
                    rid=blocked.rid, occupancy=self.kv.occupancy()))
                note_recovered("backpressure")
        group.requests = segs
        if not segs:
            return

        pr = self.prefill_runner
        store = self.kv.store
        page = self.scfg.page_size
        pt = self.pinned_tier
        pages_rows = [r.pages for r in segs]
        n_cols = pr.n_table_pages(group.bucket)
        pool_sel = wear_tr = None
        if pt is None:
            page_tables, block_tables = self.kv.fill_tables(pages_rows,
                                                            n_cols)
        else:
            page_tables, block_tables, pool_sel = self.kv.fill_tables_mixed(
                pages_rows, n_cols)
            wear_tr = store.wear_by_tier.get(pt)
            if not pool_sel.any():
                # every prompt page is tier-0 resident: single-pool path
                pt = pool_sel = wear_tr = None
        a = {k: torch.from_numpy(v).to(self.device)
             for k, v in pr.build_args(group, block_tables, pool_sel).items()}
        n_tok = group.total_tokens
        t0 = time.perf_counter()
        with obs.span("serve.prefill", step=self.step_count,
                      bucket=group.bucket, segments=len(segs),
                      tokens=n_tok):
            if pt is None:
                first, seg_logits, counts = pr._core_plain(
                    a["tokens"], a["local_pos"], a["row_tables"],
                    a["lengths"], a["write_slot"], a["write_off"],
                    a["seg_last"])
            else:
                first, seg_logits, counts = pr._core_pinned(
                    a["tokens"], a["local_pos"], a["row_tables"],
                    a["row_sel"], a["lengths"], a["write_slot"],
                    a["write_sel"], a["write_off"], a["seg_last"],
                    self._pinned_remap(wear_tr))
            if counts is not None:
                # the dispatch's expert counts ride on its one host read
                both = torch.cat([first, counts]).cpu().numpy()
                first = both[:first.shape[0]]
                self.expert_counts += both[first.shape[0]:]
            else:
                first = first.cpu().numpy()
        dt = time.perf_counter() - t0
        self.last_logits = seg_logits
        reg = obs.get_registry()
        reg.histogram("serving.prefill_latency_s",
                      "wall time of one packed prefill dispatch").observe(dt)
        reg.counter("serving.prefill_dispatches",
                    "packed prefill dispatches issued").inc()
        reg.counter("serving.prefill_tokens",
                    "prompt tokens ingested via prefill").inc(n_tok)

        # boundary accounting: closed-form totals equal to the replay
        # stream's, reported to SysMon as one streaming sampling
        prompt_lens = [len(r.prompt) for r in segs]
        d_reads, d_writes = replay_page_counts(prompt_lens, page_tables,
                                               page, self.kv.n_pages)
        self.sysmon = sysmon_mod.record_dense(
            self.sysmon, torch.from_numpy(d_reads).to(self.device),
            torch.from_numpy(d_writes).to(self.device))
        if pt is None:
            store.charge_fast_accesses(d_writes, int(d_reads.sum()))
        else:
            store.charge_accesses(d_writes, d_reads)
            # the in-dispatch appends into the pinned tier bypass the
            # store's write paths: charge their wear per token write and
            # refresh the written rows' checksums here
            wr_slots: list[int] = []
            for si, lp in enumerate(prompt_lens):
                for j in range((lp - 1) // page + 1):
                    if pool_sel[si, j]:
                        wr_slots.extend([int(block_tables[si, j])]
                                        * min(page, lp - j * page))
            if wear_tr is not None and wr_slots:
                store._account_host_writes(
                    pt, wear_tr.phys(np.asarray(wr_slots, np.int64)))
            if store.integrity.enabled and wr_slots:
                store.integrity.record(store, pt, sorted(set(wr_slots)))

        # the prompt is consumed and the first token sampled: the request
        # joins the decode batch at pos == len(prompt), or retires here
        # when one token was all it asked for
        for req, tok in zip(segs, first):
            req.tokens = list(req.prompt)
            req.generated = [int(tok)]
            self.tokens_out += 1
            self._stamp_first_token(req, self.step_count)
            if req.max_new <= 1:
                self.batcher.finish(req, self.step_count)
                self._publish_finish(req)
                self._release_pages(req)
        self._prefill_tokens_pending += n_tok

    # -- metrics -------------------------------------------------------------------
    def _stamp_first_token(self, req: Request, step: int) -> None:
        """Both TTFT clocks: the step that sampled the first token (the
        clock of the deterministic QoS gates), and the wall clock,
        published aggregate and per tenant."""
        req.first_token_step = step
        req.first_token_ts = time.monotonic()
        self._publish_first_token(req)

    def _publish_first_token(self, req: Request) -> None:
        """Wall-clock TTFT, aggregate and per tenant (a metric-name
        label)."""
        if req.ttft_s is None:
            return
        reg = obs.get_registry()
        reg.histogram("serving.ttft_s",
                      "wall-clock time to first token").observe(req.ttft_s)
        reg.histogram(f"qos.ttft_s.{req.tenant}",
                      "per-tenant wall-clock TTFT").observe(req.ttft_s)

    def _publish_finish(self, req: Request) -> None:
        """Wall-clock end-to-end latency and mean inter-token latency of
        a completed request, aggregate and per tenant."""
        if req.e2e_s is None:
            return
        reg = obs.get_registry()
        reg.histogram("serving.e2e_latency_s",
                      "wall-clock submit-to-finish latency").observe(
                          req.e2e_s)
        reg.histogram(f"qos.e2e_s.{req.tenant}",
                      "per-tenant wall-clock e2e latency").observe(req.e2e_s)
        if req.first_token_ts is not None and len(req.generated) > 1:
            itl = ((req.finish_ts - req.first_token_ts)
                   / (len(req.generated) - 1))
            reg.histogram(f"qos.itl_s.{req.tenant}",
                          "per-tenant mean inter-token latency").observe(
                              itl, n=len(req.generated) - 1)

    def _publish_dispatch_metrics(self, dt: float, k: int, batch: int) -> None:
        reg = obs.get_registry()
        reg.histogram("serving.dispatch_latency_s",
                      "wall time of one fused decode dispatch").observe(dt)
        reg.histogram("serving.token_latency_s",
                      "per-token decode latency (dispatch wall / K)"
                      ).observe(dt / k, n=k)
        reg.counter("serving.dispatches", "decode dispatches issued").inc()
        reg.counter("serving.tokens_sampled",
                    "tokens sampled across all rows").inc(k * batch)
        for qn, qv in self.batcher.depths().items():
            reg.gauge(f"serving.queue_{qn}",
                      f"scheduler {qn} queue depth").set(qv)

    # -- main loop (dispatch-boundary slow path) -----------------------------------
    def step(self) -> dict:
        # 0) fail owners of pages quarantined since the last boundary
        # (memos-pass scrub, late promotion pre-flights) before admitting
        self._drain_faults()
        # 1) admit / resume; make room by preempting if promotion fails.
        # A request that fails provisioning twice in one step is making no
        # progress — stop admitting and let dispatch/memos free capacity.
        failed: set[int] = set()
        # power governor: while over the dynamic-power budget the
        # admission width shrinks one slot per throttle level, so the
        # write stream, and with it the NVM's dynamic power, backs off
        gov = self.memos.governor
        limit = (gov.batch_limit(self.scfg.max_batch)
                 if gov is not None else None)
        with obs.span("serve.admit", step=self.step_count):
            while True:
                admitted = self.batcher.admit(limit)
                if not admitted:
                    break
                obs.get_registry().counter(
                    "serving.admissions",
                    "requests admitted into decode slots").inc(len(admitted))
                ok = True
                stuck = False
                need_room = 0
                for req in admitted:
                    if req.start_step is None:
                        req.start_step = self.step_count
                    if not self._ensure_pages(req):
                        ok = False
                        need_room = max(need_room, req.priority)
                        stuck = stuck or req.rid in failed
                        failed.add(req.rid)
                if stuck:
                    break
                # admission-time preemption is priority-bounded: room for
                # a request may only evict strictly lower priority (the
                # provision loop below keeps unbounded preemption)
                if not ok and not self._make_room(
                        need_room - 1 if self.batcher.priority_aware
                        else None):
                    break

        # 1b) prefill: every newly admitted request (pos == 0) ingests its
        # whole prompt in one packed bucketed dispatch and joins the decode
        # batch with its first token sampled.  Requests resumed mid-prompt
        # keep the replay path: their pool state is positional.
        if self.prefill_runner is not None:
            self._prefill_admitted()

        active = list(self.batcher.active)
        stats = {"step": self.step_count, "active": len(active)}
        if not active:
            self.step_count += 1
            return stats

        # 2) size the dispatch: K bounded by every sequence's remaining
        # budget, snapped to a power of two
        if self.scfg.reference:
            k = 1
        else:
            k = max(min(self.scfg.decode_block,
                        min(r.remaining_steps for r in active)), 1)
            k = 1 << (k.bit_length() - 1)

        # 3) provision tail pages for all K positions; under HBM pressure
        # first shrink the dispatch, then preempt
        with obs.span("serve.provision", step=self.step_count) as prov_sp:
            while True:
                # promotion pre-flights inside _ensure_pages can quarantine
                # a corrupt source page: fail its owner now
                self._drain_faults()
                active = [r for r in active if not r.done]
                blocked = None
                for req in active:
                    if not req.preempted and not self._ensure_pages(req, k):
                        blocked = req
                        break
                if blocked is None:
                    break
                if k > 1:
                    k //= 2
                elif not self._make_room():
                    self._fail_request(blocked, CapacityError(
                        f"request {blocked.rid}: HBM+host pools exhausted "
                        f"and no preemption victim remains",
                        rid=blocked.rid, occupancy=self.kv.occupancy()))
                    note_recovered("backpressure")
            prov_sp.set(k=k)
        active = [r for r in active if not r.preempted and not r.done]
        # pre-dispatch integrity sweep: quarantine any pinned-pool page
        # whose stored bits drifted since its last checksum and fail its
        # owner before the block tables are built
        if get_injector().enabled:
            self._predispatch_verify(active)
            self._drain_faults()
            active = [r for r in active if not r.done]
        if not active:
            self.step_count += 1
            return stats

        B = len(active)
        P = self.scfg.max_pages_per_seq
        page = self.scfg.page_size
        store = self.kv.store
        dev = self.device
        positions = np.array([r.pos for r in active], np.int32)
        prompt_lens = np.array([len(r.prompt) for r in active], np.int32)
        tokens = np.array([(r.prompt + r.generated)[r.pos] for r in active],
                          np.int32)
        pt = self.pinned_tier
        pool_sel = wear_tr = None
        if pt is None:
            page_tables, block_tables = self.kv.fill_tables(
                [r.pages for r in active], P)
        else:
            page_tables, block_tables, pool_sel = self.kv.fill_tables_mixed(
                [r.pages for r in active], P)
            wear_tr = store.wear_by_tier.get(pt)
            if not pool_sel.any():
                # every page of this dispatch is tier-0 resident: the
                # single-pool path serves it
                pt = pool_sel = wear_tr = None

        t_disp0 = time.perf_counter()
        with obs.span("serve.dispatch", step=self.step_count, k=k, batch=B,
                      path=("reference" if self.scfg.reference else "fused")
                      + ("+pinned" if pt is not None else "")):
            if self.scfg.reference:
                sampled, page_writes, logits = self._reference_decode(
                    tokens, positions, page_tables, block_tables, pool_sel,
                    None if pt is None else self._pinned_remap(wear_tr))
                if pt is not None and wear_tr is not None:
                    # host-side wear charge of the pinned tail writes (the
                    # fused path charges them on the device); it also
                    # drives the host leveler, whose advances the next
                    # dispatch sees through the remap
                    tcol = positions // page
                    tslot = block_tables[np.arange(B), tcol]
                    tpin = pool_sel[np.arange(B), tcol] > 0
                    if tpin.any():
                        store._account_host_writes(
                            pt, wear_tr.phys(tslot[tpin]))
            else:
                prompt_buf = np.zeros((B, P * page), np.int32)
                for i, r in enumerate(active):
                    prompt_buf[i, :len(r.prompt)] = r.prompt
                args = [torch.from_numpy(a).to(dev) for a in (
                    tokens, positions, prompt_buf, prompt_lens, page_tables,
                    block_tables)]
                if pt is None:
                    sampled, page_writes, logits = self._fused_decode(
                        *args, k)
                else:
                    sampled, page_writes, logits = self._dispatch_pinned(
                        args, pool_sel, wear_tr, k)
            self.last_logits = logits
        self._publish_dispatch_metrics(time.perf_counter() - t_disp0, k, B)

        # 4) access accounting: device-counted page writes bump versions
        # in one add; reads are closed-form.  The dual-pool dispatch
        # splits the charge by each page's tier.
        if pt is None:
            n_reads = int(((positions[:, None] + np.arange(k)[None, :])
                           // page + 1).sum())
            store.charge_fast_accesses(page_writes, n_reads)
        else:
            store.charge_accesses(
                page_writes, self._page_read_counts(positions, page_tables,
                                                    k))
            # refresh the checksums of the pinned rows the dispatch
            # appended to (the in-dispatch appends bypass the store's
            # write paths).  K5 runs on the dispatch's stream, so it reads
            # the pool after every append and row swap has landed.
            if store.integrity.enabled:
                written = np.nonzero(page_writes > 0)[0]
                wmask = (store.tier[written] == pt) & \
                    (store.slot[written] != NO_SLOT)
                if wmask.any():
                    store.integrity.record(
                        store, pt, np.unique(store.slot[written[wmask]]))

        # 5) advance sequences from the returned token block: tokens
        # sampled at inner step s >= emit_from[i] are new generations
        with obs.span("serve.retire", step=self.step_count):
            emit_from = np.maximum(prompt_lens - 1 - positions, 0)
            for i, req in enumerate(active):
                had_gen = bool(req.generated)
                new_gen = [int(t) for t in sampled[emit_from[i]:k, i]]
                req.generated.extend(new_gen)
                self.tokens_out += len(new_gen)
                if new_gen and not had_gen:
                    self._stamp_first_token(
                        req, self.step_count + int(emit_from[i]))
                seq = req.prompt + req.generated
                p0 = int(positions[i])
                req.tokens.extend(seq[p0:p0 + k])
                if len(req.generated) >= req.max_new:
                    self.batcher.finish(req, self.step_count + k - 1)
                    self._publish_finish(req)
                    self._release_pages(req)

        # 6) memos pass between dispatches (hot pages stay; cold /
        # preempted pages drain to the host tier), then one bulk promotion
        # for every page it demoted out from under a running sequence.
        # With overlap_plan the pass's plan runs on a worker thread across
        # the next dispatch and commits at the following boundary
        # (maybe_step returns that commit's report)
        if self.scfg.memos_enabled:
            # the sampling clock also advances by the prompt tokens prefill
            # ingested since the last tick
            pending = self._prefill_tokens_pending
            self._prefill_tokens_pending = 0
            # on_commit: re-promote pages an async commit demoted out from
            # under running sequences before the next plan snapshots, so
            # the promotion is inside that snapshot, not a mid-plan dirt
            self.sysmon, report = self.memos.maybe_step(
                self.sysmon, steps=k + pending,
                on_commit=lambda rep: self._promote_all(
                    list(self.batcher.active)))
            if report is not None:
                stats["memos"] = {
                    "migrated": report.migrations.migrated,
                    "to_fast": report.migrations.to_fast,
                    "to_slow": report.migrations.to_slow,
                    "wear_pressure": report.wear_pressure,
                    "power_pressure": report.power_pressure,
                    "power_throttle": report.power_throttle,
                    "power_mw": report.power_mw,
                    "committed_async": report.committed_async,
                    "plan_conflict": report.plan_conflict,
                    "pages_committed": report.pages_committed,
                    "pages_degraded": report.pages_degraded,
                    "pages_dropped": report.pages_dropped,
                }
                if report.nvm is not None:
                    stats["nvm"] = {
                        "wear_max": report.nvm.wear_max,
                        "slow_writes": report.nvm.slow_writes,
                        "dynamic_power_mw": report.nvm.dynamic_power_mw,
                        "lifetime_years": report.nvm.lifetime_years_actual,
                    }
                # (async commits already promoted through on_commit)
                if not self.scfg.overlap_plan:
                    self._promote_all(list(self.batcher.active))
        else:
            # no memos pass rolls the bandwidth window: roll it here
            store.roll_traffic_window()

        # 7) fault-injection tick, strictly after every write path of this
        # boundary has recorded its checksums and before the next
        # boundary's pre-dispatch verify: injected corruption always meets
        # a detection point ahead of the next serve
        inj = get_injector()
        if inj.enabled:
            inj.tick(store)

        self.step_count += k
        stats["decode_block"] = k
        stats["tokens_out"] = self.tokens_out
        stats.update(self.kv.occupancy())
        return stats

    def run(self, max_steps: int = 10_000) -> list[dict]:
        hist = []
        while not self.batcher.all_done() and self.step_count < max_steps:
            hist.append(self.step())
        # commit any plan still overlapping when the workload drains, so
        # the store and telemetry are consistent for inspection
        if self.scfg.memos_enabled:
            report = self.memos.flush()
            if report is not None and self.batcher.active:
                self._promote_all(list(self.batcher.active))
        return hist

    def close(self) -> None:
        """Release the engine's background resources (the asynchronous
        memos plan worker); safe to call more than once."""
        self.memos.close()
