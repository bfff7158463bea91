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
pass (plan + migrate + wear/energy snapshot) between dispatches.

``ServeConfig(reference=True)`` keeps the K=1 path — host argmax and
standalone per-step SysMon records — as the parity oracle for the fused
dispatch.

Prefill, pinned-host tiers, the overlapped memos plan, QoS, fault
injection and MoE are not ported; a ``ServeConfig`` asking for them
raises ``NotImplementedError``.  The KV pool takes the parameters'
dtype (bfloat16 weights serve from a bfloat16 pool).
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
from repro_torch.device import resolve_device
from repro_torch.faults.errors import CapacityError
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving.kv_cache import SERVE_TIER, PagedKVCache, PagedKVConfig
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
    # not ported: refused at construction
    overlap_plan: bool = False
    qos: object | None = None
    prefill: bool = False

    def __post_init__(self):
        asked = [name for name, on in (
            ("overlap_plan", self.overlap_plan),
            ("qos", self.qos is not None), ("prefill", self.prefill),
            ("pinned-host tiers", self.hierarchy is not None
             and bool(self.hierarchy.pinned_tiers()))) if on]
        if asked:
            raise NotImplementedError(
                f"not ported to repro_torch yet: {', '.join(asked)}")


class PagedServingEngine:
    def __init__(self, cfg: ArchConfig, params: dict, scfg: ServeConfig, *,
                 device: str | torch.device | None = "cuda"):
        if cfg.layout != "attn" or cfg.is_moe:
            raise NotImplementedError(
                "the port's paged engine serves dense attention archs")
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
        self.sysmon = sysmon_mod.init(
            self.kv.n_pages, n_banks=store.cfg.n_banks,
            n_slabs=store.cfg.n_slabs, device=self.device)
        self.memos = MemosManager(store, MemosConfig(
            interval=scfg.memos_interval, adaptive_interval=False,
            lifetime_horizon_years=scfg.lifetime_horizon_years))
        self.batcher = ContinuousBatcher(scfg.max_batch)
        self.step_count = 0
        self.tokens_out = 0
        self.rid = 0
        self.last_logits = None     # final inner step's logits, on device

    # -- request API -----------------------------------------------------------
    def submit(self, prompt: list[int], max_new: int) -> Request:
        cap = self.scfg.max_pages_per_seq * self.scfg.page_size
        if len(prompt) + max_new > cap:
            raise CapacityError(
                f"sequence needs {len(prompt) + max_new} positions but "
                f"max_pages_per_seq*page_size = {cap}")
        req = Request(self.rid, list(prompt), max_new, arrival=self.step_count)
        req.submit_ts = time.monotonic()
        req.tokens = []          # processed tokens (prompt-consumed + generated)
        req.generated = []
        self.rid += 1
        self.batcher.submit(req)
        return req

    # -- page management ---------------------------------------------------------
    def _ensure_pages(self, req: Request, k: int = 1) -> bool:
        """Provision ``req`` for the next ``k`` decode positions: allocate
        the tail pages covering pos .. pos+k-1 and promote every page not
        in tier 0."""
        need = (req.pos + k - 1) // self.scfg.page_size + 1
        while len(req.pages) < need:
            pid = self.kv.new_page(SERVE_TIER)
            if pid is None:
                return False
            req.pages.append(pid)
        return self._promote_all([req])

    def _release_pages(self, req: Request) -> None:
        for pid in req.pages:
            self.kv.free_page(pid)
        req.pages = []

    def _promote_all(self, reqs: list[Request]) -> bool:
        """Promote every non-resident page of ``reqs`` in one batched
        migration."""
        pids = [p for req in reqs for p in req.pages]
        if not pids:
            return True
        mask = self.kv.resident_mask(pids)
        if not mask.all():
            cold = [p for p, m in zip(pids, mask) if not m]
            self.memos.engine.migrate_locked(cold, SERVE_TIER)
            mask = self.kv.resident_mask(pids)
        return bool(mask.all())

    def _make_room(self) -> bool:
        """Preempt the most recent running sequence and eagerly demote its
        tier-0 pages (deepest tier first), so admission is never blocked
        on a lazy memos drain."""
        victim = self.batcher.preempt_lowest()
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

    # -- model compute -------------------------------------------------------------
    def _decode_core(self, tokens: torch.Tensor, positions: torch.Tensor,
                     block_tables: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
        """One decode step for the batch: write the new token's K/V into
        the tier-0 pool (in place) *before* attention, then run the layer
        stack through the paged-attention kernel.  tokens/positions [B];
        block_tables [B, P] int32 tier-0 slots; lengths int32 [B]
        (including the current token).  Returns logits [B, Vp]."""
        cfg = self.cfg
        params = self.params
        page = self.scfg.page_size
        pool = self.kv.store.fast_pool
        B = tokens.shape[0]
        h = T.embed_in(params, cfg, tokens.long()[:, None])
        cos, sin = L.rope_angles(positions[:, None], cfg.head_dim,
                                 cfg.rope_theta)
        b_idx = torch.arange(B, device=tokens.device)
        pos = positions.long()
        slot = block_tables.long()[b_idx, pos // page]
        off = pos % page
        for l, lp in enumerate(params["layers"]):
            x = L.rms_norm(h, lp["ln1"], eps=cfg.norm_eps,
                           gemma_style=cfg.gemma_norm)
            q, k, v = attn_mod.project_qkv(lp["attn"], x, cos, sin)
            pool[slot, l, 0, off] = k[:, 0].to(pool.dtype)
            pool[slot, l, 1, off] = v[:, 0].to(pool.dtype)
            out = paged_attention(q[:, 0], *self.kv.layer_pools(l),
                                  block_tables, lengths)
            wo = lp["attn"]["wo"]
            out = out.reshape(B, -1) @ wo.reshape(-1, wo.shape[-1])
            h = h + out[:, None, :]
            h = T.ffn_block(lp, cfg, h)
        h = L.rms_norm(h, params["final_norm"], eps=cfg.norm_eps,
                       gemma_style=cfg.gemma_norm)
        return T.logits_out(params, cfg, h)[:, 0]

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

    def _fused_decode(self, tokens, positions, prompt_buf, prompt_len,
                      page_tables, block_tables, k_steps: int):
        """K inner decode steps enqueued back to back: device-side argmax
        feeds the next step, SysMon records and the page-write counters
        accumulate on the device.  Returns ([K, B] sampled tokens and
        [n_pages] page writes as numpy — the dispatch's only host reads —
        and the last step's logits on the device)."""
        cfg = self.cfg
        page = self.scfg.page_size
        dev = self.device
        B, P = block_tables.shape
        b_idx = torch.arange(B, device=dev)
        col = torch.arange(P, dtype=torch.int32, device=dev)[None, :]
        ones = torch.ones(B, dtype=torch.int32, device=dev)
        page_writes = torch.zeros(self.kv.n_pages, dtype=torch.int32,
                                  device=dev)
        sampled_all = torch.empty((k_steps, B), dtype=torch.int32, device=dev)
        logits = None
        for s in range(k_steps):
            logits = self._decode_core(tokens, positions, block_tables,
                                       positions + 1)
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
            sampled_all[s] = sampled
            tokens, positions = nxt_tok, nxt_pos
        return (sampled_all.cpu().numpy(), page_writes.cpu().numpy(),
                logits)

    def _reference_decode(self, tokens, positions, page_tables,
                          block_tables):
        """The K=1 oracle: one decode step, argmax on the host, and the two
        SysMon samplings recorded as standalone calls."""
        page = self.scfg.page_size
        P = page_tables.shape[1]
        B = tokens.shape[0]
        dev = self.device
        logits = self._decode_core(
            torch.from_numpy(tokens).to(dev),
            torch.from_numpy(positions).to(dev),
            torch.from_numpy(block_tables).to(dev),
            torch.from_numpy(positions + 1).to(dev))
        sampled = torch.argmax(logits[:, :self.cfg.vocab], dim=-1).cpu() \
            .numpy().astype(np.int32)[None, :]
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

    # -- metrics -------------------------------------------------------------------
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
        # 1) admit / resume; make room by preempting if promotion fails.
        # A request that fails provisioning twice in one step is making no
        # progress — stop admitting and let dispatch/memos free capacity.
        failed: set[int] = set()
        with obs.span("serve.admit", step=self.step_count):
            while True:
                admitted = self.batcher.admit()
                if not admitted:
                    break
                obs.get_registry().counter(
                    "serving.admissions",
                    "requests admitted into decode slots").inc(len(admitted))
                ok = True
                stuck = False
                for req in admitted:
                    if req.start_step is None:
                        req.start_step = self.step_count
                    if not self._ensure_pages(req):
                        ok = False
                        stuck = stuck or req.rid in failed
                        failed.add(req.rid)
                if stuck:
                    break
                if not ok and not self._make_room():
                    break

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
            prov_sp.set(k=k)
        active = [r for r in active if not r.preempted and not r.done]
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
        page_tables, block_tables = self.kv.fill_tables(
            [r.pages for r in active], P)

        t_disp0 = time.perf_counter()
        with obs.span("serve.dispatch", step=self.step_count, k=k, batch=B,
                      path="reference" if self.scfg.reference else "fused"):
            if self.scfg.reference:
                sampled, page_writes, logits = self._reference_decode(
                    tokens, positions, page_tables, block_tables)
            else:
                prompt_buf = np.zeros((B, P * page), np.int32)
                for i, r in enumerate(active):
                    prompt_buf[i, :len(r.prompt)] = r.prompt
                sampled, page_writes, logits = self._fused_decode(
                    torch.from_numpy(tokens).to(dev),
                    torch.from_numpy(positions).to(dev),
                    torch.from_numpy(prompt_buf).to(dev),
                    torch.from_numpy(prompt_lens).to(dev),
                    torch.from_numpy(page_tables).to(dev),
                    torch.from_numpy(block_tables).to(dev), k)
            self.last_logits = logits
        self._publish_dispatch_metrics(time.perf_counter() - t_disp0, k, B)

        # 4) access accounting: device-counted page writes bump versions
        # in one add; reads are closed-form
        n_reads = int(((positions[:, None] + np.arange(k)[None, :])
                       // page + 1).sum())
        store.charge_fast_accesses(page_writes, n_reads)

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
                    req.first_token_step = self.step_count + int(emit_from[i])
                    req.first_token_ts = time.monotonic()
                seq = req.prompt + req.generated
                p0 = int(positions[i])
                req.tokens.extend(seq[p0:p0 + k])
                if len(req.generated) >= req.max_new:
                    self.batcher.finish(req, self.step_count + k - 1)
                    self._release_pages(req)

        # 6) memos pass between dispatches (hot pages stay; cold /
        # preempted pages drain to the host tier), then one bulk promotion
        # for every page it demoted out from under a running sequence
        if self.scfg.memos_enabled:
            self.sysmon, report = self.memos.maybe_step(self.sysmon, steps=k)
            if report is not None:
                stats["memos"] = {
                    "migrated": report.migrations.migrated,
                    "to_fast": report.migrations.to_fast,
                    "to_slow": report.migrations.to_slow,
                    "wear_pressure": report.wear_pressure,
                }
                if report.nvm is not None:
                    stats["nvm"] = {
                        "wear_max": report.nvm.wear_max,
                        "slow_writes": report.nvm.slow_writes,
                        "dynamic_power_mw": report.nvm.dynamic_power_mw,
                        "lifetime_years": report.nvm.lifetime_years_actual,
                    }
                self._promote_all(list(self.batcher.active))
        else:
            # no memos pass rolls the bandwidth window: roll it here
            store.roll_traffic_window()

        self.step_count += k
        stats["decode_block"] = k
        stats["tokens_out"] = self.tokens_out
        stats.update(self.kv.occupancy())
        return stats

    def run(self, max_steps: int = 10_000) -> list[dict]:
        hist = []
        while not self.batcher.all_done() and self.step_count < max_steps:
            hist.append(self.step())
        return hist
