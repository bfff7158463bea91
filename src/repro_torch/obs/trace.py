"""Low-overhead span tracer — the timeline half of ``repro_torch.obs``.

The paper's memos is "powered by a kernel-level monitoring module"; this
is its user-space analogue for the repro: monotonic-clock spans recorded
into a **preallocated ring buffer**, thread-aware so the asynchronous
memos pass's worker-thread plan spans interleave correctly with the main
thread's dispatch spans when exported to Chrome's trace-event format
(``obs/export.py`` -> chrome://tracing / Perfetto).

Design constraints, in order:

  * **disabled is (near) free** — ``Tracer.span()`` on a disabled tracer
    is one attribute load + one branch and returns a shared immutable
    no-op context manager: no event, no allocation, no attribute
    retention.  Instrumentation can therefore live permanently on the
    serving hot path's *host* sections (the jitted dispatch itself is
    opaque to host tracing by construction — its wall time is the
    enclosing span).
  * **enabled is cheap** — recording one span is two ``monotonic_ns``
    calls, one small object, and one ring-slot store under a lock (spans
    are recorded at *exit*, so the buffer sees one entry per span, not
    two).  The ring never grows: when full, the oldest events are
    overwritten and counted in ``n_dropped`` rather than stalling or
    reallocating.
  * **threads attribute themselves** — every event records the OS-level
    ``threading.get_ident()`` of the recording thread; the tracer keeps a
    tid -> thread-name map so exporters can emit proper per-thread
    tracks.

Span nesting needs no explicit parent pointers: within one thread,
context-manager discipline guarantees child spans are fully contained in
their parent's [start, start+dur) interval, which is exactly the nesting
model Chrome trace "X" (complete) events use.
"""
from __future__ import annotations

import threading
import time
from typing import NamedTuple


class SpanEvent(NamedTuple):
    """One completed span (ph="X") or instant marker (ph="i")."""

    name: str
    ph: str            # "X" complete span | "i" instant event
    ts_ns: int         # monotonic start time
    dur_ns: int        # 0 for instants
    tid: int           # OS thread ident of the recording thread
    attrs: dict | None


class _NullSpan:
    """The shared do-nothing span handed out while tracing is disabled:
    enters, exits, and swallows ``set()`` without recording anything."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NULL_SPAN = _NullSpan()


class _Span:
    """A live span: times itself between ``__enter__`` and ``__exit__``
    and records one event on exit."""

    __slots__ = ("_tracer", "name", "attrs", "t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict | None):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> None:
        """Attach attributes discovered mid-span (e.g. the dispatch size
        chosen after provisioning)."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.monotonic_ns()
        self._tracer._record(self.name, "X", self.t0, t1 - self.t0,
                             self.attrs)
        return False


class Tracer:
    """Preallocated-ring span recorder (see module docstring)."""

    def __init__(self, capacity: int = 65536, enabled: bool = False):
        assert capacity > 0
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._buf: list[SpanEvent | None] = [None] * self.capacity
        self._n = 0                       # total events ever recorded
        self._lock = threading.Lock()
        self._thread_names: dict[int, str] = {}

    # -- recording -------------------------------------------------------------
    def span(self, name: str, **attrs):
        """Context manager timing one span.  Disabled -> the shared no-op
        span (no event, no retained attributes)."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, attrs or None)

    def instant(self, name: str, **attrs) -> None:
        """Record a zero-duration marker (Chrome "i" event)."""
        if not self.enabled:
            return
        self._record(name, "i", time.monotonic_ns(), 0, attrs or None)

    def _record(self, name: str, ph: str, ts_ns: int, dur_ns: int,
                attrs: dict | None) -> None:
        tid = threading.get_ident()
        if tid not in self._thread_names:
            self._thread_names[tid] = threading.current_thread().name
        ev = SpanEvent(name, ph, ts_ns, dur_ns, tid, attrs)
        with self._lock:
            self._buf[self._n % self.capacity] = ev
            self._n += 1

    # -- inspection ------------------------------------------------------------
    @property
    def n_recorded(self) -> int:
        """Total events recorded since the last ``clear()`` (including
        events already overwritten by ring wraparound)."""
        return self._n

    @property
    def n_dropped(self) -> int:
        """Events lost to ring wraparound."""
        return max(self._n - self.capacity, 0)

    @property
    def thread_names(self) -> dict[int, str]:
        return dict(self._thread_names)

    def events(self) -> list[SpanEvent]:
        """Surviving events, oldest first (recording order = span *end*
        order; exporters sort by start time where it matters)."""
        with self._lock:
            n, buf = self._n, list(self._buf)
        if n <= self.capacity:
            return [e for e in buf[:n] if e is not None]
        start = n % self.capacity
        return buf[start:] + buf[:start]

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._n = 0
            self._thread_names.clear()
