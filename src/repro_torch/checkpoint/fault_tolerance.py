"""Fault-tolerance runtime (torch twin of
``repro.checkpoint.fault_tolerance``): heartbeats, straggler mitigation,
elastic re-meshing.

At 1000+ nodes the failure model is: (a) hard node loss (process gone),
(b) stragglers (a slow host dragging the synchronous collective), (c)
transient step failures.  The controller-side pieces here are pure logic
(testable on one host) and drive the same mechanisms a deployment uses:
restore from a checkpoint onto a smaller mesh, or drop/requeue a
straggler's shard.

``ElasticMeshPlan`` keeps the ``model`` axis intact (tensor parallelism
needs the whole group: losing one card of a group loses the group) and
shrinks the ``data``/``pod`` axes to the largest power of two that fits,
the usual elastic policy for 2D meshes.  Specs name mesh axes, not
ranks, so restoring onto the shrunk mesh is
``Checkpointer.restore(..., shardings=)`` with the same specs' placements
on the new mesh; the global batch is kept by raising the
gradient-accumulation steps (the same optimizer trajectory up to the
order of the batch's elements).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class HeartbeatMonitor:
    """Tracks per-host step-completion timestamps; flags dead hosts and
    stragglers (step latency > factor x running median)."""
    n_hosts: int
    dead_timeout_s: float = 60.0
    straggler_factor: float = 3.0
    window: int = 16

    def __post_init__(self):
        now = time.monotonic()
        self.last_seen = [now] * self.n_hosts
        self.latencies: list[list[float]] = [[] for _ in range(self.n_hosts)]

    def beat(self, host: int, step_latency_s: float,
             now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        self.last_seen[host] = now
        lat = self.latencies[host]
        lat.append(step_latency_s)
        if len(lat) > self.window:
            lat.pop(0)

    def dead_hosts(self, now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        return [h for h, t in enumerate(self.last_seen)
                if now - t > self.dead_timeout_s]

    def stragglers(self) -> list[int]:
        meds = sorted(sum(l) / len(l) for l in self.latencies if l)
        if not meds:
            return []
        median = meds[len(meds) // 2]
        out = []
        for h, l in enumerate(self.latencies):
            if l and (sum(l) / len(l)) > self.straggler_factor * median:
                out.append(h)
        return out


@dataclass(frozen=True)
class ElasticMeshPlan:
    """New mesh after losing ``lost_hosts`` hosts."""
    old_shape: tuple[int, ...]
    new_shape: tuple[int, ...]
    axes: tuple[str, ...]
    grad_accum_scale: int   # multiply grad-accum steps by this to keep
                            # the global batch constant

    @property
    def chips_before(self) -> int:
        n = 1
        for s in self.old_shape:
            n *= s
        return n

    @property
    def chips_after(self) -> int:
        n = 1
        for s in self.new_shape:
            n *= s
        return n


def plan_elastic_remesh(shape: tuple[int, ...], axes: tuple[str, ...],
                        lost_chips: int) -> ElasticMeshPlan:
    """Shrink the leading data-parallel axis (pod-major) to the largest
    power-of-two that fits the surviving chips, preserving the model axis."""
    assert axes[-1] == "model", "model axis must be innermost"
    model = shape[-1]
    data_total = 1
    for s in shape[:-1]:
        data_total *= s
    surviving = data_total * model - lost_chips
    new_data = 1
    while new_data * 2 * model <= surviving:
        new_data *= 2
    if len(shape) == 3:  # (pod, data, model)
        pod = min(shape[0], new_data)
        new_shape = (pod, new_data // pod, model)
    else:
        new_shape = (new_data, model)
    scale = max(1, data_total // new_data)
    return ElasticMeshPlan(shape, new_shape, axes, scale)


@dataclass
class StragglerPolicy:
    """Synchronous-training straggler mitigation: after ``patience``
    consecutive flags, the controller (a) reroutes that host's data shard
    to its DP peers (work requeue), and (b) if flagged again, triggers the
    elastic re-mesh path.  Backup-task dispatch (speculative re-execution
    of the slow shard) is returned as the intermediate action."""
    patience: int = 3
    flags: dict = field(default_factory=dict)

    def observe(self, flagged: list[int]) -> dict[int, str]:
        actions: dict[int, str] = {}
        for h in list(self.flags):
            if h not in flagged:
                del self.flags[h]
        for h in flagged:
            self.flags[h] = self.flags.get(h, 0) + 1
            if self.flags[h] >= 2 * self.patience:
                actions[h] = "remesh"
            elif self.flags[h] >= self.patience:
                actions[h] = "backup_dispatch"
            else:
                actions[h] = "observe"
        return actions
