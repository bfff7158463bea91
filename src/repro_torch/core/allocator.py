"""Sub-Buddy allocator with color-indexed free lists (paper Sec. 6.2, Fig. 12).

The paper splits the Linux Buddy System into per-channel *sub-buddies* and
indexes each order's free blocks by a 9-bit color formed from the bank and
cache-slab bits of the PFN, giving O(1) color-exact allocation
(Algorithm 3).  TPUs have no physical-address coloring, so the color is an
explicit field of the page-pool index space instead of PFN bits:

    color(page) = page_index mod n_colors          (order-0 blocks)
    color(block) = color of its first page         (higher orders)

with n_colors = n_banks * n_slabs (default 32 * 16 = 512, as in Fig. 12).
A block of order o covers 2**o consecutive colors (wrapping), exactly like
the paper's order-1 blocks spanning two colors, so the color of the first
page plus the order determines which colors the block can satisfy.

Supports the generalized (i, j, k)-bit allocation of Sec. 5.2 through
``color_mask``: any free block whose color matches ``want & mask`` is
eligible, letting callers constrain only bank bits, only slab bits, both,
or neither.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field


@dataclass
class SubBuddyConfig:
    n_pages: int
    n_banks: int = 32
    n_slabs: int = 16
    max_order: int = 10

    @property
    def n_colors(self) -> int:
        return self.n_banks * self.n_slabs

    def color_of(self, page: int) -> int:
        return page % self.n_colors

    def bank_of(self, page: int) -> int:
        # low bits: slab (rows within a bank share a slab stride); high: bank.
        return (page % self.n_colors) // self.n_slabs

    def slab_of(self, page: int) -> int:
        return page % self.n_slabs


class SubBuddyAllocator:
    """One sub-buddy (one channel/tier).  All operations are O(1) in the
    fast path; splitting a larger block (Algorithm 3's Expand_color_block)
    costs O(max_order)."""

    def __init__(self, cfg: SubBuddyConfig):
        self.cfg = cfg
        # free_lists[order][color] -> deque of block start pages
        self.free_lists: list[dict[int, deque[int]]] = [
            {} for _ in range(cfg.max_order + 1)
        ]
        self._free_blocks: set[tuple[int, int]] = set()  # (start, order)
        self._allocated: set[tuple[int, int]] = set()    # live allocations
        self._retired: set[int] = set()   # quarantined order-0 starts
        self.n_free = 0
        # generation counter: bumped by every successful alloc/free, so a
        # snapshot (clone) taken at generation g is interchangeable with
        # the live allocator for as long as the live generation stays g —
        # the async memos commit adopts the plan's clone wholesale when no
        # allocator call interleaved, instead of replaying per reservation
        self.gen = 0
        self._seed_initial_blocks()

    # -- internal ---------------------------------------------------------
    def _seed_initial_blocks(self) -> None:
        """Carve the pool into maximal aligned blocks."""
        start = 0
        n = self.cfg.n_pages
        while start < n:
            order = self.cfg.max_order
            while order > 0 and (start % (1 << order) != 0 or start + (1 << order) > n):
                order -= 1
            self._push(start, order)
            start += 1 << order

    def _push(self, start: int, order: int) -> None:
        color = self.cfg.color_of(start)
        self.free_lists[order].setdefault(color, deque()).append(start)
        self._free_blocks.add((start, order))
        self.n_free += 1 << order

    def _pop_exact(self, order: int, color: int) -> int | None:
        dq = self.free_lists[order].get(color)
        while dq:
            start = dq.popleft()
            if (start, order) in self._free_blocks:
                self._free_blocks.discard((start, order))
                self.n_free -= 1 << order
                return start
        return None

    def _block_colors(self, order: int) -> int:
        """Number of distinct colors covered by an order-o block."""
        return min(1 << order, self.cfg.n_colors)

    # -- public API ---------------------------------------------------------
    def alloc(self, order: int = 0, color: int | None = None,
              color_mask: int | None = None) -> int | None:
        """Allocate a block of 2**order pages whose first-page color matches
        ``color`` under ``color_mask`` (None = any color).  Returns the start
        page index or None when the request cannot be satisfied.

        Algorithm 3: exact-color hit is O(1); otherwise walk to higher
        orders, split the covering block, and keep the sub-block whose color
        matches (Expand_color_block)."""
        if color is None:
            got = self._alloc_any(order)
            if got is not None:
                self._allocated.add((got, order))
                self.gen += 1
            return got
        n_colors = self.cfg.n_colors
        mask = n_colors - 1 if color_mask is None else color_mask
        want = color & mask

        # 1) exact O(1) probes at the requested order over matching colors.
        for c, dq in list(self.free_lists[order].items()):
            if (c & mask) == want and dq:
                got = self._pop_exact(order, c)
                if got is not None:
                    self._allocated.add((got, order))
                    self.gen += 1
                    return got

        # 2) split a higher-order block covering a matching color.
        for o in range(order + 1, self.cfg.max_order + 1):
            span = self._block_colors(o)
            for c, dq in list(self.free_lists[o].items()):
                if not dq:
                    continue
                # colors covered: c, c+1, ..., c+span-1 (mod n_colors)
                covered_match = any(((c + d) % n_colors) & mask == want
                                    for d in range(span))
                if not covered_match:
                    continue
                start = self._pop_exact(o, c)
                if start is None:
                    continue
                got = self._expand_color_block(start, o, order, want, mask)
                self._allocated.add((got, order))
                self.gen += 1
                return got
        return None

    def _expand_color_block(self, start: int, order: int, target_order: int,
                            want: int, mask: int) -> int:
        """Split ``start`` (order) down to target_order keeping a sub-block
        whose first-page color matches; free the other halves."""
        n_colors = self.cfg.n_colors
        while order > target_order:
            order -= 1
            half = 1 << order
            lo, hi = start, start + half
            # choose the half that still covers a matching color
            span = self._block_colors(order)
            lo_match = any(((self.cfg.color_of(lo) + d) % n_colors) & mask == want
                           for d in range(span))
            if lo_match:
                self._push(hi, order)
                start = lo
            else:
                self._push(lo, order)
                start = hi
        return start

    def _alloc_any(self, order: int) -> int | None:
        for o in range(order, self.cfg.max_order + 1):
            for c in list(self.free_lists[o].keys()):
                start = self._pop_exact(o, c)
                if start is not None:
                    while o > order:
                        o -= 1
                        self._push(start + (1 << o), o)
                    return start
        return None

    def retire(self, start: int) -> bool:
        """Permanently withhold an allocated order-0 block (bad-slot
        quarantine): the block stays in the allocated set — so
        ``check_consistency``'s exact-partition invariant holds and the
        slot is never handed out again — but any later ``free`` of it is
        rejected.  Pool capacity shrinks by one page for the lifetime of
        the allocator.  Returns False if the block isn't currently
        allocated (already freed — nothing to retire)."""
        if (start, 0) not in self._allocated:
            return False
        self._retired.add(start)
        self.gen += 1        # snapshots taken before the retire are stale
        return True

    @property
    def n_retired(self) -> int:
        return len(self._retired)

    def free(self, start: int, order: int = 0) -> None:
        """Return a block; merge buddies greedily (classic buddy coalesce)."""
        if order == 0 and start in self._retired:
            raise ValueError(f"free of quarantined block ({start}, 0)")
        if (start, order) not in self._allocated:
            raise ValueError(f"double/invalid free of block ({start}, {order})")
        self._allocated.discard((start, order))
        self.gen += 1
        while order < self.cfg.max_order:
            buddy = start ^ (1 << order)
            if (buddy, order) not in self._free_blocks:
                break
            # unlink buddy and merge
            self._free_blocks.discard((buddy, order))
            self.n_free -= 1 << order
            start = min(start, buddy)
            order += 1
        self._push(start, order)

    def clone(self) -> "SubBuddyAllocator":
        """A bookkeeping deep copy sharing the (immutable) config.

        The asynchronous memos plan phase simulates Algorithm-2 slot
        reservations against a clone on its worker thread, so the live
        allocator is never touched off the dispatch-boundary path.  At
        commit time, if the live allocator's ``gen`` still equals the
        generation the clone was taken at, no call interleaved and the
        clone (reservations included) simply *becomes* the live allocator
        — an O(1) adoption; otherwise the recorded reservations are
        replayed call by call and any matching prefix still commits."""
        other = object.__new__(SubBuddyAllocator)
        other.cfg = self.cfg
        other.free_lists = [{c: deque(dq) for c, dq in bucket.items()}
                            for bucket in self.free_lists]
        other._free_blocks = set(self._free_blocks)
        other._allocated = set(self._allocated)
        other._retired = set(self._retired)
        other.n_free = self.n_free
        other.gen = self.gen
        return other

    def check_consistency(self) -> None:
        """Bookkeeping invariants (test support): the free-block set and the
        allocation set partition the pool exactly, ``n_free`` matches the
        free-block set, and live free-list entries are indexed under their
        block's color.  Raises AssertionError on violation."""
        assert self.n_free == sum(1 << o for _, o in self._free_blocks), \
            "n_free disagrees with the free-block set"
        covered: set[int] = set()
        for start, order in self._free_blocks | self._allocated:
            span = set(range(start, start + (1 << order)))
            assert not (span & covered), \
                f"block ({start}, {order}) overlaps another live block"
            covered |= span
        assert covered == set(range(self.cfg.n_pages)), \
            "free + allocated blocks do not cover the pool exactly"
        for order, bucket in enumerate(self.free_lists):
            for color, dq in bucket.items():
                for start in dq:
                    if (start, order) in self._free_blocks:   # skip stale
                        assert self.cfg.color_of(start) == color, \
                            f"block {start} filed under wrong color {color}"

    def alloc_pages(self, n: int, color: int | None = None,
                    color_mask: int | None = None) -> list[int] | None:
        """Allocate n order-0 pages (not necessarily contiguous)."""
        got: list[int] = []
        for _ in range(n):
            p = self.alloc(0, color, color_mask)
            if p is None:
                for q in got:
                    self.free(q, 0)
                return None
            got.append(p)
        return got
