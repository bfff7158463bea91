"""Tenant classes, per-class SLOs, and the serving QoS configuration.

Three canonical classes cover the paper's co-location story:

  * ``latency_critical`` — interactive traffic.  Highest admission /
    preemption priority, and a page-utility weight > 1 so its KV pages
    resist demotion to the slow tiers (the per-tenant ranking follows
    the page-utility performance model of Li et al., with the tenant
    weight as a multiplier on per-page utility).
  * ``standard``        — default traffic; neutral in every policy.
  * ``batch``           — throughput traffic.  Lowest priority: first
    preemption victim, first to be deferred when the power governor
    shrinks admission.

SLO targets exist in two clocks: wall-clock milliseconds (reported) and
engine decode *steps* (deterministic — the clock the benchmark gates
use, since a trace replay produces the same step timeline on every
machine).
"""
from __future__ import annotations

from dataclasses import dataclass, field

LATENCY_CRITICAL = "latency_critical"
STANDARD = "standard"
BATCH = "batch"
CLASSES = (LATENCY_CRITICAL, STANDARD, BATCH)


@dataclass(frozen=True)
class SloSpec:
    """Per-class service-level objectives.  ``None`` disables a target."""
    ttft_p99_ms: float | None = None      # wall-clock time to first token
    itl_p99_ms: float | None = None       # wall-clock inter-token latency
    ttft_steps: int | None = None         # step-clock TTFT (deterministic)


# class -> (priority, page-utility weight, SLO).  Priorities are ordinal
# (higher admits first / preempts last); weights multiply per-page
# utility in the memos placement ranking.
CLASS_DEFAULTS: dict[str, tuple[int, float, SloSpec]] = {
    LATENCY_CRITICAL: (2, 4.0, SloSpec(ttft_p99_ms=500.0, itl_p99_ms=100.0,
                                       ttft_steps=24)),
    STANDARD: (1, 1.0, SloSpec(ttft_p99_ms=2000.0, itl_p99_ms=200.0,
                               ttft_steps=64)),
    BATCH: (0, 1.0, SloSpec()),           # best-effort: no targets
}


@dataclass(frozen=True)
class TenantSpec:
    """One tenant: a named stream of requests with a class and overrides."""
    name: str
    tier_class: str = STANDARD
    priority: int = 1
    page_weight: float = 1.0
    slo: SloSpec = field(default_factory=SloSpec)

    def __post_init__(self):
        if self.tier_class not in CLASSES:
            raise ValueError(f"tenant {self.name!r}: unknown class "
                             f"{self.tier_class!r}; pick from {CLASSES}")
        if self.page_weight <= 0:
            raise ValueError(f"tenant {self.name!r}: page_weight must be "
                             f"positive, got {self.page_weight}")


def tenant_for_class(name: str, tier_class: str = STANDARD, *,
                     priority: int | None = None,
                     page_weight: float | None = None) -> TenantSpec:
    """A tenant with its class's default priority / weight / SLO."""
    prio, weight, slo = CLASS_DEFAULTS[tier_class]
    return TenantSpec(name=name, tier_class=tier_class,
                      priority=prio if priority is None else priority,
                      page_weight=weight if page_weight is None else
                      page_weight, slo=slo)


# the spec every un-tenanted request gets: standard class, neutral
# priority 0 and weight 1.0 so an engine with a bare QoSConfig behaves
# bit-identically to one with no QoSConfig at all
DEFAULT_TENANT = TenantSpec(name="default", tier_class=STANDARD,
                            priority=0, page_weight=1.0)


@dataclass(frozen=True)
class QoSConfig:
    """Serving-engine QoS knobs.  The default instance is inert: no
    tenants, no power cap — every scheduler / placement decision is
    bit-identical to an engine with ``qos=None``."""

    # with tenants, admission and preemption are priority-aware and each
    # request's pages carry its tenant's weight into memos placement
    tenants: tuple[TenantSpec, ...] = ()
    # dynamic-power budget (mW) enforced by the memos power governor
    # against the sum of per-wear-tier ``NvmReport.dynamic_power_mw``;
    # None disables the cap
    power_budget_mw: float | None = None

    def spec(self, tenant: str | None) -> TenantSpec:
        """The tenant's spec, or the inert default for unknown/None."""
        if tenant is not None:
            for t in self.tenants:
                if t.name == tenant:
                    return t
        return DEFAULT_TENANT

    @property
    def any_weighted(self) -> bool:
        return any(t.page_weight != 1.0 for t in self.tenants)
