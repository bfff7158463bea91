"""Deterministic, seeded fault injector — the torch twin of
``repro.faults.injector``.

One module-global :class:`FaultInjector` (``faults.configure(...)`` /
``faults.reset()``) feeds four injection sites:

* **NVM media errors** (:meth:`FaultInjector.tick`, called by the
  serving engine at the end of every step boundary): seeded single-bit
  flips and stuck-at bits scattered into live rows of the host tiers —
  numpy pools and the pinned-host pool alike — with per-slot fault
  probability scaled by the tier's wear counters (``wear_bias``), so
  heavily worn slots fail first.  Stuck-at faults persist: they
  re-assert on every tick until the slot is quarantined.  Bits are
  flipped through each pool's zero-copy numpy view (``pool.raw()``),
  which waits for the card's stream first, so a flip never races a
  dispatch that is still writing the pinned pool.
* **plan-worker faults** (:meth:`maybe_plan_fault`, called inside
  ``MemosManager._plan_job`` on the worker thread): injected exceptions
  and artificial latency; a delay longer than ``plan_timeout_s`` is the
  hang that trips the watchdog.
* **migration faults** (:meth:`maybe_migration_fault`, at the head of
  every per-(src,dst) bulk move): transient failures beneath the
  migration engine's retry-with-backoff loop.
* **allocation pressure** (:meth:`maybe_alloc_fail`, inside
  ``TierStore.allocate``): simulated pool exhaustion.

Each site draws from its own seeded stream, seeded as the JAX
package's are, so a seed replays the same storm in both packages over
the same store state; the plan stream is drawn only on the worker
thread, so its draws never race the main thread's.  Disarmed, no site
touches an RNG or any state.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from .errors import InjectedPlanFault, TransientMigrationFault

_NO_SLOT = -1      # mirrors tiers.NO_SLOT (faults sits below core)


@dataclass(frozen=True)
class FaultConfig:
    seed: int = 0
    # media: per-live-slot probability per engine step (before wear bias)
    media_flip_rate: float = 0.0      # transient single-bit flips
    media_stuck_rate: float = 0.0     # persistent stuck-at bits
    wear_bias: float = 4.0            # fault-rate multiplier slope vs. mean wear
    # asynchronous plan worker
    plan_exception_rate: float = 0.0  # per plan job
    plan_delay_rate: float = 0.0      # per plan job
    plan_delay_s: float = 0.0         # > plan_timeout_s == a hang
    # migration bulk moves
    migrate_fail_rate: float = 0.0    # per per-(src,dst) move attempt
    # allocator
    alloc_fail_rate: float = 0.0      # per TierStore.allocate call
    enabled: bool = True


class FaultInjector:
    def __init__(self, cfg: FaultConfig | None):
        self.cfg = cfg or FaultConfig(enabled=False)
        self.enabled = cfg is not None and self.cfg.enabled
        s = self.cfg.seed
        # one stream per site, at the JAX package's seed offsets: the
        # plan stream is drawn on the worker thread, the rest on the main
        # thread, so a seed's storm does not depend on thread interleaving
        self._rng_media = np.random.RandomState(s)
        self._rng_plan = np.random.RandomState(s + 1)
        self._rng_migrate = np.random.RandomState(s + 2)
        self._rng_alloc = np.random.RandomState(s + 3)
        # persistent stuck-at bits: tier -> list of (phys, byte, bit, val)
        self._stuck: dict[int, list[tuple[int, int, int, int]]] = {}
        self.counts = {"media_flip": 0, "media_stuck": 0, "plan_exception": 0,
                       "plan_delay": 0, "migrate": 0, "alloc": 0}

    # -- shared accounting -----------------------------------------------------
    def _note(self, kind: str, n: int = 1) -> None:
        self.counts[kind] += n
        from repro_torch import obs
        reg = obs.get_registry()
        reg.counter("faults.injected", "total injected faults").inc(n)
        reg.counter(f"faults.injected_{kind}",
                    f"injected {kind} faults").inc(n)

    @property
    def total_injected(self) -> int:
        return sum(self.counts.values())

    # -- site 1: NVM media errors ---------------------------------------------
    def tick(self, store) -> int:
        """Scatter media faults into live host/pinned rows (one engine
        step boundary).  Returns the number of bits actually corrupted."""
        if not self.enabled:
            return 0
        c = self.cfg
        n = 0
        for t in range(store.n_tiers):
            if store.is_device_tier(t):
                continue
            n += self._reassert_stuck(store, t)
            if c.media_flip_rate <= 0 and c.media_stuck_rate <= 0:
                continue
            live = np.nonzero((store.tier == t)
                              & (store.slot != _NO_SLOT))[0]
            if live.size == 0:
                continue
            phys = store._phys(t, store.slot[live].astype(np.int64))
            weight = np.ones(live.size)
            w = store.wear_by_tier.get(t)
            if w is not None and c.wear_bias > 0:
                wear = np.asarray(w.wear_counts(), np.float64)
                weight += c.wear_bias * wear[phys] / (wear.mean() + 1.0)
            raw = store.pools[t].raw()
            row_bytes = self._row_bytes(raw)
            r = self._rng_media.random_sample(live.size)
            for i in np.nonzero(r < np.minimum(
                    c.media_flip_rate * weight, 1.0))[0]:
                byte = int(self._rng_media.randint(row_bytes))
                bit = int(self._rng_media.randint(8))
                self._xor_bit(raw, int(phys[i]), byte, bit)
                self._note("media_flip")
                n += 1
            if c.media_stuck_rate > 0:
                r = self._rng_media.random_sample(live.size)
                for i in np.nonzero(r < np.minimum(
                        c.media_stuck_rate * weight, 1.0))[0]:
                    fault = (int(phys[i]),
                             int(self._rng_media.randint(row_bytes)),
                             int(self._rng_media.randint(8)),
                             int(self._rng_media.randint(2)))
                    self._stuck.setdefault(t, []).append(fault)
                    if self._force_bit(raw, *fault):
                        n += 1
                    self._note("media_stuck")
        return n

    def _reassert_stuck(self, store, tier: int) -> int:
        """Stuck-at bits re-corrupt rewritten rows on every tick."""
        faults = self._stuck.get(tier)
        if not faults:
            return 0
        raw = store.pools[tier].raw()
        n = 0
        for fault in faults:
            if self._force_bit(raw, *fault):
                self._note("media_stuck")
                n += 1
        return n

    @staticmethod
    def _row_bytes(raw: np.ndarray) -> int:
        """Bytes of one pool row of a host pool's storage array."""
        return int(np.prod(raw.shape[1:])) * raw.dtype.itemsize

    @staticmethod
    def _xor_bit(raw: np.ndarray, phys: int, byte: int, bit: int) -> None:
        """Flip one bit of row ``phys`` of a host pool's storage array (a
        numpy pool, or the zero-copy view of the pinned pool)."""
        flat = raw[phys].view(np.uint8).reshape(-1)
        flat[byte] ^= np.uint8(1 << bit)

    @staticmethod
    def _force_bit(raw: np.ndarray, phys: int, byte: int, bit: int,
                   val: int) -> bool:
        """Set one bit to ``val``; returns True if the byte changed."""
        flat = raw[phys].view(np.uint8).reshape(-1)
        if (int(flat[byte]) >> bit) & 1 == val:
            return False
        flat[byte] ^= np.uint8(1 << bit)
        return True

    # -- site 2: asynchronous plan worker --------------------------------------
    def maybe_plan_fault(self) -> None:
        """Called inside the plan job, on the worker thread."""
        if not self.enabled:
            return
        c = self.cfg
        if (c.plan_delay_rate > 0 and c.plan_delay_s > 0
                and self._rng_plan.random_sample() < c.plan_delay_rate):
            self._note("plan_delay")
            time.sleep(c.plan_delay_s)
        if (c.plan_exception_rate > 0
                and self._rng_plan.random_sample() < c.plan_exception_rate):
            self._note("plan_exception")
            raise InjectedPlanFault("injected plan-worker exception")

    # -- site 3: migration bulk moves -----------------------------------------
    def maybe_migration_fault(self, src_tier: int, dst_tier: int,
                              pages: int) -> None:
        if not self.enabled or self.cfg.migrate_fail_rate <= 0:
            return
        if self._rng_migrate.random_sample() < self.cfg.migrate_fail_rate:
            self._note("migrate")
            raise TransientMigrationFault(
                f"injected transient fault moving {pages} pages "
                f"t{src_tier}->t{dst_tier}")

    # -- site 4: allocation pressure ------------------------------------------
    def maybe_alloc_fail(self, tier: int) -> bool:
        if not self.enabled or self.cfg.alloc_fail_rate <= 0:
            return False
        if self._rng_alloc.random_sample() < self.cfg.alloc_fail_rate:
            self._note("alloc")
            return True
        return False


def note_recovered(kind: str, n: int = 1) -> None:
    """Record a successful recovery action (retry landed, sync fallback
    served, slot quarantined, backpressure, rung re-promoted) into the
    obs registry."""
    from repro_torch import obs
    reg = obs.get_registry()
    reg.counter("faults.recovered", "total recovery actions").inc(n)
    reg.counter(f"faults.recovered_{kind}", f"recoveries: {kind}").inc(n)


_injector = FaultInjector(None)


def configure(cfg: FaultConfig | None) -> FaultInjector:
    """Install (or with ``None`` remove) the global fault injector."""
    global _injector
    _injector = FaultInjector(cfg)
    return _injector


def get_injector() -> FaultInjector:
    return _injector


def reset() -> None:
    configure(None)
