"""Exporters for the ``repro_torch.obs`` tracer and metrics registry
(a copy of the JAX package's ``repro.obs.export``; the output is
byte-equal for the same events and metrics).

Three formats:

  * **Chrome trace-event JSON** (``chrome_trace`` / ``write_chrome_trace``)
    — load the file in chrome://tracing or https://ui.perfetto.dev to see
    the dispatch/plan/commit pipeline as per-thread tracks: with
    ``overlap_plan`` the ``memos.plan`` spans sit on the ``memos-plan_*``
    worker track directly under the main thread's next ``serve.dispatch``
    span — the overlap the async pipeline exists to create, visible
    instead of inferred.
  * **JSONL** (``to_jsonl`` / ``write_jsonl``) — one event object per
    line, for ad-hoc grepping/pandas.
  * **Prometheus-style text** (``prometheus_text`` / ``write_prometheus``)
    — the metrics registry as ``# TYPE`` blocks; histograms emit
    cumulative ``_bucket{le=...}`` series plus ``_sum`` / ``_count``.
"""
from __future__ import annotations

import json
from pathlib import Path

from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import Tracer

PID = 0   # single-process: one pid, one track group


def _json_attrs(attrs: dict | None) -> dict:
    if not attrs:
        return {}
    return {k: (v if isinstance(v, (int, float, str, bool, type(None)))
                else str(v)) for k, v in attrs.items()}


def chrome_trace(tracer: Tracer) -> dict:
    """The tracer's surviving events as a Chrome trace-event object
    (timestamps microseconds, rebased to the earliest event)."""
    events = tracer.events()
    t0 = min((e.ts_ns for e in events), default=0)
    out = []
    for tid, name in sorted(tracer.thread_names.items()):
        out.append({"ph": "M", "name": "thread_name", "pid": PID,
                    "tid": tid, "args": {"name": name}})
    for e in events:
        ev = {"name": e.name, "ph": e.ph, "ts": (e.ts_ns - t0) / 1e3,
              "pid": PID, "tid": e.tid, "args": _json_attrs(e.attrs)}
        if e.ph == "X":
            ev["dur"] = e.dur_ns / 1e3
        else:              # instant events need a scope
            ev["s"] = "t"
        out.append(ev)
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"dropped_events": tracer.n_dropped}}


def write_chrome_trace(path: str | Path, tracer: Tracer) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(chrome_trace(tracer), indent=1))
    return path


def to_jsonl(tracer: Tracer) -> str:
    lines = []
    for e in tracer.events():
        lines.append(json.dumps({
            "name": e.name, "ph": e.ph, "ts_ns": e.ts_ns,
            "dur_ns": e.dur_ns, "tid": e.tid,
            "thread": tracer.thread_names.get(e.tid, ""),
            "args": _json_attrs(e.attrs)}))
    return "\n".join(lines) + ("\n" if lines else "")


def write_jsonl(path: str | Path, tracer: Tracer) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(to_jsonl(tracer))
    return path


def _prom_name(name: str) -> str:
    """Metric name -> Prometheus-legal name (dots and dashes fold to
    underscores, prefixed ``repro_`` as the JAX package's exporter does,
    so both packages' series group together)."""
    safe = "".join(c if (c.isalnum() or c == "_") else "_" for c in name)
    return f"repro_{safe}"


def prometheus_text(registry: MetricsRegistry) -> str:
    lines: list[str] = []
    for name, m in sorted(registry.collect().items()):
        pn = _prom_name(name)
        if m.help:
            lines.append(f"# HELP {pn} {m.help}")
        if isinstance(m, Counter):
            lines.append(f"# TYPE {pn} counter")
            lines.append(f"{pn} {m.value}")
        elif isinstance(m, Gauge):
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f"{pn} {m.value}")
        elif isinstance(m, Histogram):
            lines.append(f"# TYPE {pn} histogram")
            cum = 0
            for edge, c in zip(m.edges, m.counts):
                cum += c
                if c:          # sparse: only emit buckets that moved
                    lines.append(f'{pn}_bucket{{le="{edge:g}"}} {cum}')
            lines.append(f'{pn}_bucket{{le="+Inf"}} {m.count}')
            lines.append(f"{pn}_sum {m.sum}")
            lines.append(f"{pn}_count {m.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(path: str | Path, registry: MetricsRegistry) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(prometheus_text(registry))
    return path
