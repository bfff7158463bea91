"""Multi-tenant QoS: workload model, scheduling policy knobs, power cap
(the torch port's own copy of ``repro.qos``; it holds no tensor code).

The paper's second headline number is **+23.6% QoS** — memos keeps
latency-critical workloads fast while co-running batch workloads share
the hierarchy.  This package makes that a first-class, measurable
dimension of the serving stack:

  * :mod:`repro_torch.qos.tenants` — tenant classes (``latency_critical`` /
    ``standard`` / ``batch``) with per-class SLOs, priorities, and the
    per-page utility weight that flows into memos placement (Li et al.'s
    page-utility model, tenant weight as a multiplier);
  * :mod:`repro_torch.qos.traces` — open-loop arrival-trace generators
    (Poisson / bursty / diurnal, mixed prompt & output length
    distributions) writing replayable JSONL traces under
    ``benchmarks/traces/``;
  * :mod:`repro_torch.qos.power` — the power-cap governor: consumes
    ``NvmReport.dynamic_power_mw`` against a budget and throttles batch
    admission / biases placement toward the low-energy medium while over
    cap.

With no tenants configured (a bare :class:`QoSConfig`, or none at all)
every hook degenerates to the pre-QoS behavior bit for bit — pinned by
``tests/test_torch_qos.py``.
"""
from .power import PowerGovernor
from .tenants import (BATCH, CLASSES, LATENCY_CRITICAL, STANDARD, QoSConfig,
                      SloSpec, TenantSpec, tenant_for_class)

__all__ = [
    "BATCH", "CLASSES", "LATENCY_CRITICAL", "STANDARD",
    "PowerGovernor", "QoSConfig", "SloSpec", "TenantSpec",
    "tenant_for_class",
]
