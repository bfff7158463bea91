"""Metrics registry — counters, gauges, and log-bucketed histograms.

The aggregate half of ``repro_torch.obs`` (the span tracer in ``obs/trace.py``
is the timeline half): MemosManager, TierStore, and the serving engine
publish into one :class:`MetricsRegistry` at pass/dispatch boundaries —
per-token latency, dispatch wall time, plan latency vs. the overlap
window, pages committed/degraded, per-tier occupancy and per-(src,dst)
migration bytes, per-wear-tier energy and max wear.

Histograms are **log-bucketed**: geometric bucket edges cover many
decades of latency in ~a hundred int64 counters, so p50/p99 estimation
costs O(buckets) with relative error bounded by the bucket growth factor
(default ``2**0.25`` ~ 19% width, interpolated below that).  All metrics
are lock-protected; publication only happens at boundary granularity
(never inside the jitted dispatch), so the locks are uncontended in
practice.
"""
from __future__ import annotations

import math
import threading


class Counter:
    """Monotonically increasing value (int or float increments)."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def to_dict(self) -> dict:
        return {"type": "counter", "value": self._value}


class Gauge:
    """Last-write-wins value."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def to_dict(self) -> dict:
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Log-bucketed histogram over (0, inf).

    Bucket upper edges are the geometric series ``lo * factor**i`` up to
    ``hi`` plus one overflow bucket; ``observe(v, n)`` is one searchsorted
    + three adds.  ``quantile(q)`` interpolates linearly inside the
    winning bucket and clamps to the observed min/max, so exact-value
    streams (all observations equal) report exact quantiles.
    """

    def __init__(self, name: str, help: str = "", lo: float = 1e-7,
                 hi: float = 1e3, factor: float = 2 ** 0.25):
        assert lo > 0 and hi > lo and factor > 1
        self.name = name
        self.help = help
        n = int(math.ceil(math.log(hi / lo) / math.log(factor))) + 1
        self.edges = [lo * factor ** i for i in range(n)]   # upper bounds
        self.counts = [0] * (n + 1)                         # + overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    def _bucket(self, v: float) -> int:
        # first edge >= v (bisect on a ~100-entry list)
        lo_i, hi_i = 0, len(self.edges)
        while lo_i < hi_i:
            mid = (lo_i + hi_i) // 2
            if self.edges[mid] < v:
                lo_i = mid + 1
            else:
                hi_i = mid
        return lo_i

    def observe(self, v: float, n: int = 1) -> None:
        """Record ``n`` observations of value ``v`` (the fused dispatch
        observes its per-token latency once with n=K)."""
        if n <= 0:
            return
        v = float(v)
        with self._lock:
            self.counts[self._bucket(v)] += n
            self.count += n
            self.sum += v * n
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0 <= q <= 1); 0.0 when empty."""
        if not self.count:
            return 0.0
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.edges[i - 1] if i > 0 else 0.0
                hi = self.edges[i] if i < len(self.edges) else self.max
                frac = (rank - cum) / c
                est = lo + (hi - lo) * frac
                return min(max(est, self.min), self.max)
            cum += c
        return self.max

    def to_dict(self) -> dict:
        return {
            "type": "histogram", "count": self.count, "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "mean": self.mean,
            "p50": self.quantile(0.5), "p90": self.quantile(0.9),
            "p99": self.quantile(0.99),
        }


class MetricsRegistry:
    """Name -> metric map with get-or-create accessors.

    ``reset()`` drops every metric — benchmark sweeps call it between
    engine configs so each config's histograms stand alone.  Holders of a
    metric object across a reset keep a detached instance; re-fetching by
    name after a reset returns the fresh one, which is why publishers
    look metrics up at publish time instead of caching them.
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        return self._get(name, Histogram, help=help, **kw)

    def collect(self) -> dict[str, object]:
        with self._lock:
            return dict(self._metrics)

    def to_dict(self) -> dict:
        """{name: metric.to_dict()} snapshot, sorted by name."""
        return {n: m.to_dict() for n, m in sorted(self.collect().items())}

    def flat(self) -> dict:
        """Flattened scalar view: counters/gauges as ``name``, histogram
        summary stats as ``name.count`` / ``name.p50`` / ... — the shape
        benchmark JSONs and ``report.py`` consume."""
        out = {}
        for n, m in sorted(self.collect().items()):
            d = m.to_dict()
            if d["type"] == "histogram":
                for k in ("count", "sum", "mean", "p50", "p90", "p99"):
                    out[f"{n}.{k}"] = d[k]
            else:
                out[n] = d["value"]
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()
