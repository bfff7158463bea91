"""repro_torch.obs — spans and metrics for the port's memos pipeline.

A copy of the JAX package's ``repro.obs``:

  * **spans** (``obs/trace.py``) — monotonic-clock spans in a
    preallocated ring buffer, disabled by default and a true no-op while
    disabled;
  * **metrics** (``obs/metrics.py``) — counters, gauges and
    log-bucketed histograms that ``MemosManager``, ``TierStore`` and
    ``PagedServingEngine`` publish into at pass/dispatch boundaries;
  * **exporters** (``obs/export.py``) — Chrome trace-event JSON
    (chrome://tracing / Perfetto), JSONL and Prometheus-style text.

The module-level singletons (``get_tracer()`` / ``get_registry()``) are
the process's default sinks; tests isolate themselves with ``reset()``.
"""
from __future__ import annotations

from . import export  # noqa: F401  (re-export: obs.export.write_chrome_trace)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import NULL_SPAN, SpanEvent, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "SpanEvent",
    "Tracer", "NULL_SPAN", "configure", "get_registry", "get_tracer",
    "instant", "reset", "span", "tracing_enabled", "export",
]

_tracer = Tracer(enabled=False)
_registry = MetricsRegistry()


def get_tracer() -> Tracer:
    return _tracer


def get_registry() -> MetricsRegistry:
    return _registry


def configure(*, trace: bool | None = None,
              capacity: int | None = None) -> None:
    """Flip tracing on/off and/or resize the span ring.  Resizing drops
    recorded events (the ring is preallocated, never grown in place)."""
    global _tracer
    if capacity is not None and capacity != _tracer.capacity:
        _tracer = Tracer(capacity=capacity, enabled=_tracer.enabled)
    if trace is not None:
        _tracer.enabled = bool(trace)


def tracing_enabled() -> bool:
    return _tracer.enabled


def span(name: str, **attrs):
    """Time a span against the process tracer (no-op context manager
    while tracing is disabled)."""
    t = _tracer
    if not t.enabled:
        return NULL_SPAN
    return t.span(name, **attrs)


def instant(name: str, **attrs) -> None:
    t = _tracer
    if t.enabled:
        t.instant(name, **attrs)


def reset() -> None:
    """Drop all recorded spans and all metrics (keeps the enabled flag
    and ring capacity)."""
    _tracer.clear()
    _registry.reset()
