"""Paged KV cache on top of the memos TierStore (torch twin of
``repro.serving.kv_cache``).

Logical page = one ``page_size``-token span of one sequence, payload
[L, 2(K/V), page, Hkv, Dh] across all layers; pages migrate between the
hierarchy's tiers as a unit.  Tier 0 is the serving tier: block tables
map (sequence, span) -> logical page -> tier-0 pool slot for the
paged-attention kernel, so a page must be promoted to tier 0 before it
can be attended to — unless the deepest tier is a pinned-host pool,
whose pages the dual-pool decode attends to and appends into in place
(``fill_tables_mixed``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.hierarchy import MemoryHierarchy
from repro_torch.core.tiers import (NO_SLOT, StoreConfig, TierStore,
                                    to_host_raw)

SERVE_TIER = 0   # compute only ever reads tier 0 (the fastest device pool)


@dataclass
class PagedKVConfig:
    n_layers: int
    n_kv_heads: int
    head_dim: int
    page_size: int = 16
    fast_slots: int = 64          # HBM pool capacity (two-tier default)
    slow_slots: int = 512         # host pool capacity (two-tier default)
    dtype: torch.dtype = torch.float32
    # full tier stack; None -> MemoryHierarchy.two_tier(fast, slow)
    hierarchy: MemoryHierarchy | None = None
    # logical page count; None -> total backing capacity (tiers 1..deepest)
    n_pages: int | None = None


class PagedKVCache:
    def __init__(self, cfg: PagedKVConfig, *,
                 device: str | torch.device | None = "cuda"):
        self.cfg = cfg
        hier = cfg.hierarchy or MemoryHierarchy.two_tier(cfg.fast_slots,
                                                         cfg.slow_slots)
        n_pages = (cfg.n_pages if cfg.n_pages is not None
                   else sum(t.slots for t in hier.tiers[1:]))
        shape = (cfg.n_layers, 2, cfg.page_size, cfg.n_kv_heads, cfg.head_dim)
        self.store = TierStore(StoreConfig(
            n_pages=n_pages, page_shape=shape, hierarchy=hier,
            dtype=cfg.dtype), device=device)
        self.n_pages = n_pages
        self._free_ids = list(range(n_pages - 1, -1, -1))

    @property
    def pinned_tier(self) -> int | None:
        """The deepest tier when it is a pinned-host pool (the kernels
        address it in place, so the decode serves KV out of it and
        appends to it); None otherwise."""
        deepest = self.store.hierarchy.deepest
        return deepest if self.store.hierarchy[deepest].is_pinned else None

    # -- logical page lifecycle ------------------------------------------------
    def new_page(self, tier: int = SERVE_TIER) -> int | None:
        """Bind a fresh logical page, preferring ``tier`` and cascading
        down the hierarchy (in bandwidth-headroom order) when a pool is
        full."""
        if not self._free_ids:
            return None
        pid = self._free_ids.pop()
        order = [tier] + self.store.backing_tier_order(start=tier + 1)
        for t in order:
            if self.store.allocate(pid, t):
                return pid
        self._free_ids.append(pid)
        return None

    def free_page(self, pid: int) -> None:
        self.store.release(pid)
        self._free_ids.append(pid)

    def is_resident(self, pid: int) -> bool:
        """Whether logical page ``pid`` is live in the serving pool."""
        return int(self.store.tier[pid]) == SERVE_TIER and \
            int(self.store.slot[pid]) != NO_SLOT

    def resident_mask(self, pids) -> np.ndarray:
        """bool [k]: which of ``pids`` are live in the serving pool."""
        pids = np.asarray(pids, np.int64)
        return (self.store.tier[pids] == SERVE_TIER) & \
            (self.store.slot[pids] != NO_SLOT)

    def servable_mask(self, pids) -> np.ndarray:
        """bool [k]: which of ``pids`` the dispatch can attend to — tier-0
        residents plus, when the deepest tier is pinned-host, residents
        of that pool (served in place, no promotion needed)."""
        pids = np.asarray(pids, np.int64)
        live = self.store.slot[pids] != NO_SLOT
        ok = self.store.tier[pids] == SERVE_TIER
        pt = self.pinned_tier
        if pt is not None:
            ok = ok | (self.store.tier[pids] == pt)
        return ok & live

    def fast_slots_of(self, pids) -> np.ndarray:
        """int32 [k] tier-0 pool slots for a batch of logical pages (all
        must be HBM-resident)."""
        pids = np.asarray(pids, np.int64)
        assert self.resident_mask(pids).all(), \
            f"non-resident pages in {pids.tolist()}"
        return self.store.slot[pids].astype(np.int32)

    def fill_tables(self, pages_rows: list[list[int]],
                    n_cols: int) -> tuple[np.ndarray, np.ndarray]:
        """(page_tables, block_tables) int32 [B, n_cols]: logical ids feed
        SysMon charging, tier-0 pool slots feed the attention kernel.
        Unused columns are zero and masked by length downstream."""
        B = len(pages_rows)
        page_tables = np.zeros((B, n_cols), np.int32)
        block_tables = np.zeros((B, n_cols), np.int32)
        for i, pg in enumerate(pages_rows):
            pg = pg[:n_cols]
            page_tables[i, :len(pg)] = pg
            block_tables[i, :len(pg)] = self.fast_slots_of(pg)
        return page_tables, block_tables

    def fill_tables_mixed(self, pages_rows: list[list[int]], n_cols: int
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(page_tables, block_tables, pool_sel) int32 [B, n_cols] for the
        dual-pool dispatch: every page must be servable.  ``block_tables``
        holds the slot in the page's own pool — the tier-0 slot, or the
        pinned pool's **logical** slot, which the dispatch translates
        through the wear-leveling remap; ``pool_sel`` is 1 where the page
        lives in the pinned pool."""
        pt = self.pinned_tier
        assert pt is not None, "fill_tables_mixed needs a pinned deepest tier"
        store = self.store
        B = len(pages_rows)
        page_tables = np.zeros((B, n_cols), np.int32)
        block_tables = np.zeros((B, n_cols), np.int32)
        pool_sel = np.zeros((B, n_cols), np.int32)
        for i, pg in enumerate(pages_rows):
            pg = np.asarray(pg[:n_cols], np.int64)
            assert self.servable_mask(pg).all(), \
                f"non-servable pages in {pg.tolist()}"
            page_tables[i, :len(pg)] = pg
            block_tables[i, :len(pg)] = store.slot[pg].astype(np.int32)
            pool_sel[i, :len(pg)] = (store.tier[pg] == pt).astype(np.int32)
        return page_tables, block_tables, pool_sel

    def write_token_kv(self, pid: int, layer_kv: torch.Tensor,
                       offset: int) -> None:
        """One token's K/V of every layer, layer_kv [L, 2, Hkv, Dh], at
        in-page ``offset`` of page ``pid``, wherever it lives: in place in
        a device pool; in place in a pinned pool's physical row (after the
        card's queued writes to it have landed), charged to its wear and
        integrity records; read-modify-write of a numpy host page.  Bumps
        the page's version (the dirty bit of optimistic migration)."""
        store = self.store
        t, slot = int(store.tier[pid]), int(store.slot[pid])
        assert slot != NO_SLOT
        pool = store.pools[t]
        if store.is_device_tier(t):
            pool.data[slot, :, :, offset] = layer_kv.to(
                device=pool.data.device, dtype=pool.data.dtype)
        elif store.is_pinned_tier(t):
            assert not pool.quantized, \
                "token-granular appends need a lossless pinned pool"
            phys = store._phys_one(t, slot)
            pool.raw()[phys, :, :, offset] = to_host_raw(
                layer_kv.to(dtype=pool.dtype).cpu())
            store._account_host_writes(t, np.asarray([phys]))
            store.integrity.record(store, t, [slot])
        else:
            page = pool.read_one(store._phys_one(t, slot))
            page[:, :, offset] = layer_kv.float().cpu().numpy()
            store._host_write(t, slot, page)
        store.writes_to[t] += 1
        store.bump_version(pid)

    def layer_pools(self, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(k_pool, v_pool) strided views [n_fast_slots, page, Hkv, Dh] of
        the live tier-0 pool (never copies)."""
        pool = self.store.fast_pool
        return pool[:, layer, 0], pool[:, layer, 1]

    def occupancy(self) -> dict:
        return self.store.occupancy()
