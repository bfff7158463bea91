"""Continuous-batching scheduler with memos-aware, priority-aware preemption.

Requests stream in; the scheduler packs up to ``max_batch`` sequences into
decode slots.  When the HBM page pool can't host a new sequence's pages,
the lowest-priority *running* sequence is preempted: its pages stop being
touched, SysMon sees them go cold/RD, and the memos loop migrates them to
the host tier (lazy path) — freeing HBM without an explicit eviction
policy.  On resume the engine requests an *eager* promotion of the
sequence's pages (paper Sec. 6.3's eager mode is exactly this user-driven
path).

Multi-tenant QoS (``repro_torch.qos``) adds ``tenant`` / ``priority`` /
``weight`` to :class:`Request` and makes both scheduler decisions
priority-aware:

  * **admission** (``priority_aware=True``): highest priority first;
    within a priority, resumed (preempted) requests before new ones,
    then FIFO.  The legacy order — drain ``preempted`` before
    ``waiting`` unconditionally — let a resumed batch request starve a
    newly-arrived latency-critical one; it remains the default policy
    and is pinned bit-identical by tests/test_scheduler.py.
  * **preemption**: lowest priority first, then LIFO within the
    priority (most recently admitted — keeps older sequences' latency
    bounded, the max-slowdown QoS metric).  With uniform priorities this
    reduces exactly to the legacy pure-LIFO victim.

Requests also carry real wall-clock timestamps (submit / first token /
finish) so TTFT and end-to-end latency are measurable per tenant; the
engine stamps ``submit_ts`` / ``first_token_ts``, the scheduler stamps
``finish_ts`` on finish/fail.  Timestamps never feed a decision, so they
cannot perturb the served tokens.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int
    arrival: int = 0
    # multi-tenant QoS identity (set by the engine's submit from
    # ServeConfig.qos): priority orders admission / preemption, weight
    # multiplies per-page utility in memos placement
    tenant: str = "default"
    priority: int = 0
    weight: float = 1.0
    # runtime state
    tokens: list[int] = field(default_factory=list)   # processed tokens
    generated: list[int] = field(default_factory=list)
    pages: list[int] = field(default_factory=list)   # logical page ids
    slot: int | None = None
    done: bool = False
    preempted: bool = False
    start_step: int | None = None
    finish_step: int | None = None
    first_token_step: int | None = None   # step-clock TTFT (deterministic)
    # wall-clock lifecycle timestamps (time.monotonic seconds)
    submit_ts: float | None = None
    first_token_ts: float | None = None
    finish_ts: float | None = None
    # terminal failure (CapacityError, PageCorruptionError, ...): the
    # request retired without completing; ``generated`` holds whatever
    # was produced before the fault
    error: Exception | None = None

    @property
    def pos(self) -> int:
        return len(self.tokens)

    @property
    def remaining_steps(self) -> int:
        """Decode steps left until this request finishes: the unconsumed
        prompt prefix (steps that don't emit) plus the generation budget.
        The engine sizes its fused dispatch K so no sequence overruns."""
        return max(len(self.prompt) - 1 - self.pos, 0) + \
            (self.max_new - len(self.generated))

    @property
    def ttft_s(self) -> float | None:
        """Wall-clock time to first token, when both stamps exist."""
        if self.submit_ts is None or self.first_token_ts is None:
            return None
        return self.first_token_ts - self.submit_ts

    @property
    def e2e_s(self) -> float | None:
        """Wall-clock submit-to-retire latency."""
        if self.submit_ts is None or self.finish_ts is None:
            return None
        return self.finish_ts - self.submit_ts


class ContinuousBatcher:
    def __init__(self, max_batch: int, *, priority_aware: bool = False):
        self.max_batch = max_batch
        self.priority_aware = priority_aware
        self.waiting: deque[Request] = deque()
        self.running: dict[int, Request] = {}   # slot -> request
        self.preempted: deque[Request] = deque()
        self.finished: list[Request] = []
        # decision counters for the QoS harness (pure ints — the
        # scheduler stays obs-free; the engine publishes them)
        self.n_admitted = 0
        self.n_preempted = 0

    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    def free_slots(self) -> list[int]:
        return [s for s in range(self.max_batch) if s not in self.running]

    def _pop_next(self) -> Request | None:
        """The next request to admit under the active policy.

        Legacy (default): drain ``preempted`` before ``waiting``, FIFO
        each — exactly the pre-QoS order.  Priority-aware: highest
        priority across *both* queues wins; within a priority resumed
        requests go first (their pages are warm and their latency clock
        has been running longest), then FIFO by arrival."""
        if not self.priority_aware:
            src = self.preempted if self.preempted else self.waiting
            return src.popleft() if src else None
        best = None
        best_key = None
        for qrank, q in enumerate((self.preempted, self.waiting)):
            for i, req in enumerate(q):
                key = (-req.priority, qrank, i)
                if best_key is None or key < best_key:
                    best, best_key = (q, i), key
        if best is None:
            return None
        q, i = best
        req = q[i]
        del q[i]
        return req

    def admit(self, limit: int | None = None) -> list[Request]:
        """Admit requests into free slots under the active policy.
        ``limit`` caps the number of *running* sequences (the power
        governor shrinks it below ``max_batch`` while over budget)."""
        admitted = []
        for slot in self.free_slots():
            if limit is not None and len(self.running) >= limit:
                break
            req = self._pop_next()
            if req is None:
                break
            req.slot = slot
            req.preempted = False
            self.running[slot] = req
            admitted.append(req)
        self.n_admitted += len(admitted)
        return admitted

    def preempt_lowest(self, max_priority: int | None = None
                       ) -> Request | None:
        """Preempt the lowest-priority running sequence; LIFO (most
        recently admitted) within the priority, which keeps older
        sequences' latency bounded — the max-slowdown QoS metric.  With
        uniform priorities this is exactly the legacy pure-LIFO victim.

        ``max_priority`` bounds the victim: None preempts regardless
        (capacity must be freed); otherwise only a victim with priority
        <= ``max_priority`` is taken, so admitting a low-priority
        request can never evict a higher-priority running one."""
        if not self.running:
            return None
        lowest = min(r.priority for r in self.running.values())
        if max_priority is not None and lowest > max_priority:
            return None
        slot = max((s for s in self.running
                    if self.running[s].priority == lowest),
                   key=lambda s: self.running[s].start_step or 0)
        req = self.running.pop(slot)
        req.slot = None
        req.preempted = True
        self.preempted.append(req)
        self.n_preempted += 1
        return req

    def finish(self, req: Request, step: int) -> None:
        if req.slot is not None:
            self.running.pop(req.slot, None)
        req.slot = None
        req.done = True
        req.finish_step = step
        req.finish_ts = time.monotonic()
        self.finished.append(req)

    def fail(self, req: Request, step: int, error: Exception) -> None:
        """Terminally fail a request wherever it sits (running slot,
        waiting queue, preempted queue): it retires with ``error`` set
        instead of silently completing or wedging the batch."""
        if req.slot is not None:
            self.running.pop(req.slot, None)
            req.slot = None
        for q in (self.waiting, self.preempted):
            try:
                q.remove(req)
            except ValueError:
                pass
        req.error = error
        req.done = True
        req.finish_step = step
        req.finish_ts = time.monotonic()
        self.finished.append(req)

    @property
    def active(self) -> list[Request]:
        return list(self.running.values())

    def all_done(self) -> bool:
        return not (self.waiting or self.running or self.preempted)

    def depths(self) -> dict[str, int]:
        """Queue depths for the obs metrics registry."""
        return {"waiting": len(self.waiting), "running": len(self.running),
                "preempted": len(self.preempted),
                "finished": len(self.finished)}
