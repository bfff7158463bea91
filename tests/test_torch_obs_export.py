"""The port's exporters (``repro_torch.obs.export``) against the JAX
package's ``repro.obs.export``: a tracer and a registry on each side,
filled by the same calls, export to byte-equal Chrome trace JSON, JSONL
and Prometheus text.  Spans are recorded at fixed timestamps (the
tracer's ``_record``, which every span and instant ends in) so both
sides hold the same events; a second thread's events check the
per-thread tracks.
"""
import json
import threading

import pytest

from repro.obs import export as jexport
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.obs.trace import Tracer as JTracer
from repro_torch import obs
from repro_torch.obs import export
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer

# (name, ph, ts_ns, dur_ns, attrs)
EVENTS = [
    ("serve.dispatch", "X", 5_000_000, 2_500_000, {"step": 3, "k": 8,
                                                   "path": "fused"}),
    ("memos.snapshot", "X", 7_600_000, 120_000, {"step": 3}),
    ("serve.admit", "X", 1_000_000, 7_000, None),
    ("faults.injected", "i", 4_200_000, 0, {"site": "media",
                                            "obj": object}),
    ("serve.retire", "X", 7_500_500, 1_250, {"ratio": 0.125,
                                             "ok": True, "none": None}),
]
WORKER = [("memos.plan", "X", 7_700_000, 900_000, {"step": 3})]


def _tracers(capacity=64):
    """A port and a JAX tracer with the same events: the main thread's,
    then one worker thread's, recorded into both from that thread."""
    tracers = (Tracer(capacity=capacity, enabled=True),
               JTracer(capacity=capacity, enabled=True))
    for tr in tracers:
        for ev in EVENTS:
            tr._record(*ev)
    t = threading.Thread(target=lambda: [tr._record(*ev) for tr in tracers
                                         for ev in WORKER],
                         name="memos-plan_0")
    t.start()
    t.join()
    return tracers


@pytest.mark.parametrize("capacity", [64, 3])
def test_chrome_trace_and_jsonl_bytes_equal_jax(capacity, tmp_path):
    """The ring's wraparound (capacity 3 drops three events) changes
    both sides alike."""
    tr, jtr = _tracers(capacity)
    assert export.chrome_trace(tr) == jexport.chrome_trace(jtr)
    p = export.write_chrome_trace(tmp_path / "port" / "trace.json", tr)
    jp = jexport.write_chrome_trace(tmp_path / "jax" / "trace.json", jtr)
    assert p.read_bytes() == jp.read_bytes()
    doc = json.loads(p.read_text())
    assert doc["otherData"]["dropped_events"] == max(0, 6 - capacity)
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M"}
    assert "memos-plan_0" in names
    assert export.to_jsonl(tr) == jexport.to_jsonl(jtr)
    p = export.write_jsonl(tmp_path / "port" / "t.jsonl", tr)
    jp = jexport.write_jsonl(tmp_path / "jax" / "t.jsonl", jtr)
    assert p.read_bytes() == jp.read_bytes()
    assert len(p.read_text().splitlines()) == min(6, capacity)


def test_empty_tracer_exports_equal_jax():
    tr, jtr = Tracer(), JTracer()
    assert export.chrome_trace(tr) == jexport.chrome_trace(jtr)
    assert export.to_jsonl(tr) == jexport.to_jsonl(jtr) == ""


def _fill_registry(reg):
    reg.counter("memos.passes", "memos passes completed").inc(3)
    reg.counter("serving.dispatches").inc()
    reg.gauge("store.t0_used", "tier-0 slots in use").set(7)
    reg.gauge("power.dynamic_mw").set(0.0125)
    h = reg.histogram("serving.dispatch_latency_s", "dispatch wall time")
    for v, n in ((0.01, 4), (0.25, 1), (3e-6, 2), (12.0, 1)):
        h.observe(v, n=n)
    reg.histogram("qos.ttft_s.lc").observe(0.0421)
    reg.histogram("qos.itl_s.bat-1", "odd-name tenant")
    return reg


def test_prometheus_bytes_equal_jax(tmp_path):
    reg, jreg = _fill_registry(MetricsRegistry()), \
        _fill_registry(JRegistry())
    text = export.prometheus_text(reg)
    assert text == jexport.prometheus_text(jreg)
    assert "# TYPE repro_memos_passes counter" in text
    assert 'repro_serving_dispatch_latency_s_bucket{le="+Inf"} 8' in text
    assert "repro_qos_itl_s_bat_1_count 0" in text
    p = export.write_prometheus(tmp_path / "port" / "m.prom", reg)
    jp = jexport.write_prometheus(tmp_path / "jax" / "m.prom", jreg)
    assert p.read_bytes() == jp.read_bytes()
    assert export.prometheus_text(MetricsRegistry()) == \
        jexport.prometheus_text(JRegistry()) == ""


def test_package_reexports_export():
    assert obs.export is export
    assert "export" in obs.__all__
    for name in ("chrome_trace", "write_chrome_trace", "to_jsonl",
                 "write_jsonl", "prometheus_text", "write_prometheus"):
        assert hasattr(obs.export, name)
