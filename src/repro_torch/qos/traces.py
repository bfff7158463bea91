"""Open-loop arrival-trace generation + replayable JSONL trace files.

The trace-replay idiom of ``benchmarks/simulator.py`` (seeded generator
-> one record per line -> replay -> JSON summary) scaled from page
traces to request traffic: each trace is a list of request arrivals —
arrival time, tenant, full prompt token ids, output budget — generated
by seeded open-loop processes so the offered load is independent of how
fast the engine serves (queues genuinely build under overload).

Arrival processes (one per tenant stream, merged by time):

  * ``poisson``  — exponential inter-arrival gaps at ``rate_rps``;
  * ``bursty``   — Poisson bursts of ``burst_size`` back-to-back
    arrivals (gap process at ``rate_rps / burst_size`` keeps the mean
    rate at ``rate_rps``), each burst spread over ``burst_spread_s``;
  * ``diurnal``  — sinusoidally modulated rate
    ``rate_rps * (1 + amplitude * sin(2 pi t / period_s))`` via
    thinning against the peak rate.

Prompt and output lengths are per-stream clipped-lognormal mixes.
Everything is drawn from ``np.random.RandomState`` seeded per stream,
and floats are rounded before writing, so the same (spec, seed) always
produces a byte-identical file — pinned by tests/test_torch_qos.py
against the JAX package's generator and the committed files.

Trace JSONL schema (documented for replay in benchmarks/traces/README.md):

  line 1:  {"meta": {"name", "seed", "version", "duration_s",
                     "steps_per_s", "vocab", "tenants": {name: class},
                     "n_requests"}}
  line 2+: {"rid", "t", "tenant", "cls", "prompt": [ids...], "max_new"}

``t`` is the arrival time in seconds; replay maps it to the engine's
deterministic step clock as ``step = floor(t * steps_per_s)``.

``write_canonical(out_dir)`` writes the canonical set into a directory
of the caller's choice; the committed copies under ``benchmarks/traces/``
are only read.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .tenants import BATCH, CLASSES, LATENCY_CRITICAL, STANDARD

TRACE_VERSION = 1


@dataclass(frozen=True)
class LengthDist:
    """Clipped-lognormal integer lengths (mixed short/long traffic)."""
    mean: float
    sigma: float = 0.4
    lo: int = 1
    hi: int = 64

    def sample(self, rng: np.random.RandomState, n: int) -> np.ndarray:
        v = rng.lognormal(mean=float(np.log(self.mean)), sigma=self.sigma,
                          size=n)
        return np.clip(np.round(v).astype(np.int64), self.lo, self.hi)


@dataclass(frozen=True)
class ArrivalSpec:
    """One tenant's open-loop arrival stream."""
    tenant: str
    tier_class: str = STANDARD
    process: str = "poisson"              # poisson | bursty | diurnal
    rate_rps: float = 4.0
    burst_size: int = 4                   # bursty only
    burst_spread_s: float = 0.05          # bursty only
    period_s: float = 2.0                 # diurnal only
    amplitude: float = 0.8                # diurnal only
    prompt: LengthDist = field(default_factory=lambda: LengthDist(6, lo=2,
                                                                  hi=16))
    output: LengthDist = field(default_factory=lambda: LengthDist(10, lo=2,
                                                                  hi=24))

    def __post_init__(self):
        if self.tier_class not in CLASSES:
            raise ValueError(f"unknown class {self.tier_class!r}")
        if self.process not in ("poisson", "bursty", "diurnal"):
            raise ValueError(f"unknown process {self.process!r}")


@dataclass
class TraceEvent:
    rid: int
    t: float                              # arrival time, seconds
    tenant: str
    cls: str
    prompt: list[int]
    max_new: int

    def step(self, steps_per_s: float) -> int:
        """Arrival on the engine's deterministic step clock."""
        return int(self.t * steps_per_s)


def _poisson_times(rate: float, duration: float,
                   rng: np.random.RandomState) -> list[float]:
    out, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / rate)
        if t >= duration:
            return out
        out.append(t)


def _bursty_times(spec: ArrivalSpec, duration: float,
                  rng: np.random.RandomState) -> list[float]:
    burst_rate = spec.rate_rps / max(spec.burst_size, 1)
    out = []
    for t0 in _poisson_times(burst_rate, duration, rng):
        offs = np.sort(rng.uniform(0.0, spec.burst_spread_s,
                                   size=spec.burst_size))
        out.extend(float(t0 + o) for o in offs if t0 + o < duration)
    return out


def _diurnal_times(spec: ArrivalSpec, duration: float,
                   rng: np.random.RandomState) -> list[float]:
    peak = spec.rate_rps * (1.0 + spec.amplitude)
    out = []
    for t in _poisson_times(peak, duration, rng):
        lam = spec.rate_rps * (1.0 + spec.amplitude
                               * np.sin(2.0 * np.pi * t / spec.period_s))
        if rng.uniform() * peak < lam:      # thinning
            out.append(t)
    return out


def generate_trace(name: str, specs: list[ArrivalSpec], duration_s: float,
                   seed: int, *, vocab: int = 256,
                   steps_per_s: float = 24.0
                   ) -> tuple[dict, list[TraceEvent]]:
    """Generate one merged, rid-ordered trace from per-tenant streams.

    Each stream draws from its own ``RandomState(seed + 7919 * index)``
    so adding a stream never perturbs the others' arrivals."""
    events: list[tuple[float, int, int, TraceEvent]] = []
    for idx, spec in enumerate(specs):
        rng = np.random.RandomState(seed + 7919 * idx)
        if spec.process == "poisson":
            times = _poisson_times(spec.rate_rps, duration_s, rng)
        elif spec.process == "bursty":
            times = _bursty_times(spec, duration_s, rng)
        else:
            times = _diurnal_times(spec, duration_s, rng)
        n = len(times)
        plens = spec.prompt.sample(rng, n)
        olens = spec.output.sample(rng, n)
        for j, t in enumerate(times):
            prompt = rng.randint(0, vocab, size=int(plens[j])).tolist()
            ev = TraceEvent(rid=-1, t=round(float(t), 6),
                            tenant=spec.tenant, cls=spec.tier_class,
                            prompt=[int(x) for x in prompt],
                            max_new=int(olens[j]))
            events.append((ev.t, idx, j, ev))
    events.sort(key=lambda e: e[:3])
    ordered = []
    for rid, (_, _, _, ev) in enumerate(events):
        ev.rid = rid
        ordered.append(ev)
    meta = {
        "name": name, "seed": seed, "version": TRACE_VERSION,
        "duration_s": duration_s, "steps_per_s": steps_per_s,
        "vocab": vocab,
        "tenants": {s.tenant: s.tier_class for s in specs},
        "n_requests": len(ordered),
    }
    return meta, ordered


def write_trace(path: Path, meta: dict, events: list[TraceEvent]) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    lines = [json.dumps({"meta": meta}, sort_keys=True)]
    for ev in events:
        lines.append(json.dumps(
            {"rid": ev.rid, "t": ev.t, "tenant": ev.tenant, "cls": ev.cls,
             "prompt": ev.prompt, "max_new": ev.max_new}, sort_keys=True))
    path.write_text("\n".join(lines) + "\n")
    return path


def read_trace(path: Path) -> tuple[dict, list[TraceEvent]]:
    lines = Path(path).read_text().splitlines()
    head = json.loads(lines[0])
    assert "meta" in head, f"{path}: first line must be the meta record"
    meta = head["meta"]
    assert meta.get("version") == TRACE_VERSION, \
        f"{path}: trace version {meta.get('version')} != {TRACE_VERSION}"
    events = []
    for line in lines[1:]:
        if not line.strip():
            continue
        d = json.loads(line)
        events.append(TraceEvent(rid=d["rid"], t=d["t"], tenant=d["tenant"],
                                 cls=d["cls"], prompt=d["prompt"],
                                 max_new=d["max_new"]))
    return meta, events


# -- the canonical committed scenario set -------------------------------------
# Small, seeded, and replayable byte-for-byte: the QoS replays read the
# committed files directly, so their results are reproducible from the
# committed traces alone.

def canonical_specs() -> dict[str, tuple[list[ArrivalSpec], float, int]]:
    """name -> (streams, duration_s, seed)."""
    lc = ArrivalSpec("lc", LATENCY_CRITICAL, process="poisson",
                     rate_rps=3.0,
                     prompt=LengthDist(5, lo=2, hi=10),
                     output=LengthDist(8, lo=4, hi=14))
    std = ArrivalSpec("std", STANDARD, process="poisson", rate_rps=4.0,
                      prompt=LengthDist(6, lo=2, hi=14),
                      output=LengthDist(10, lo=4, hi=18))
    bat = ArrivalSpec("bat", BATCH, process="bursty", rate_rps=6.0,
                      burst_size=4, burst_spread_s=0.04,
                      prompt=LengthDist(8, lo=4, hi=18),
                      output=LengthDist(12, lo=6, hi=20))
    bat_diurnal = ArrivalSpec("bat", BATCH, process="diurnal", rate_rps=5.0,
                              period_s=2.0, amplitude=0.8,
                              prompt=LengthDist(8, lo=4, hi=16),
                              output=LengthDist(12, lo=6, hi=20))
    return {
        # overload: offered load ~2x the engine's service rate, so the
        # priority policy has queues to discriminate between
        "mixed_overload": ([lc, std, bat], 4.0, 7),
        # steady mixed load for the power-cap scenario
        "steady_power": ([std, bat_diurnal], 4.0, 11),
        # shorter mix replayed under a media fault storm
        "storm_mix": ([lc, std,
                       ArrivalSpec("bat", BATCH, process="poisson",
                                   rate_rps=3.0,
                                   prompt=LengthDist(7, lo=4, hi=14),
                                   output=LengthDist(10, lo=6, hi=16))],
                      3.0, 13),
    }


def write_canonical(out_dir: Path) -> list[Path]:
    out = []
    for name, (specs, duration, seed) in canonical_specs().items():
        meta, events = generate_trace(name, specs, duration, seed)
        out.append(write_trace(Path(out_dir) / f"{name}.jsonl", meta,
                               events))
    return out

