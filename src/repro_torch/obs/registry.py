"""Process-wide metrics registry: counters, gauges, mergeable histograms.

The port's copy of `repro.obs.registry`. The sweep runner, the training
loop, the divergence observatory and the kernel dispatch record into
this registry and export the snapshot schema of the JAX package
(``repro.obs/1``), so the snapshots of the two packages merge.

Histograms use sparse log-spaced buckets (growth ``2**0.25`` per bucket,
~9% worst-case relative quantile error) so that snapshots from different
processes merge *exactly*: merging is bucket-count addition, never a
re-sampling of raw values.  Exact ``count``/``sum``/``min``/``max`` are
tracked alongside, and quantile estimates are clamped into
``[min, max]``.

Metric names are flat dotted strings (``serve.queue_delay_s``).  Labeled
series use the suffix convention ``name{k="v"}`` produced by
:func:`labeled`; the Prometheus exporter splits the suffix back into
real labels.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Mapping, Optional

SCHEMA = "repro.obs/1"

# Bucket geometry shared by every histogram so any two snapshots merge.
_LO = 1e-9
_GROWTH = 2.0 ** 0.25
_LOG_GROWTH = math.log(_GROWTH)


def labeled(name: str, **labels: object) -> str:
    """Return ``name{k="v",...}`` with labels sorted for determinism."""
    if not labels:
        return name
    body = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return name + "{" + body + "}"


def split_labels(name: str) -> tuple:
    """Split ``name{k="v"}`` into (base, {k: v}); plain names get {}."""
    if "{" not in name or not name.endswith("}"):
        return name, {}
    base, _, body = name.partition("{")
    out: Dict[str, str] = {}
    for part in body[:-1].split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        out[k.strip()] = v.strip().strip('"')
    return base, out


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Streaming histogram over sparse log-spaced buckets.

    Mergeable: two histograms with the same geometry (always true here)
    merge by adding bucket counts.  Quantiles are read from the
    cumulative bucket walk at the geometric midpoint of the hit bucket.
    """

    __slots__ = ("name", "count", "sum", "min", "max", "buckets", "_lock")

    def __init__(self, name: str = "") -> None:
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: Dict[int, int] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _index(v: float) -> int:
        if v <= _LO:
            return 0
        return 1 + int(math.log(v / _LO) / _LOG_GROWTH)

    @staticmethod
    def _midpoint(idx: int) -> float:
        if idx <= 0:
            return _LO / 2.0
        # geometric midpoint of [lo*g^(i-1), lo*g^i)
        return _LO * (_GROWTH ** (idx - 0.5))

    def observe(self, v: float) -> None:
        v = max(0.0, v)
        idx = self._index(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            self.buckets[idx] = self.buckets.get(idx, 0) + 1

    def quantile(self, q: float) -> float:
        with self._lock:
            if self.count == 0:
                return 0.0
            target = max(1, math.ceil(q * self.count))
            seen = 0
            for idx in sorted(self.buckets):
                seen += self.buckets[idx]
                if seen >= target:
                    est = self._midpoint(idx)
                    return min(max(est, self.min), self.max)
            return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def merge(self, other: "Histogram") -> None:
        with self._lock:
            self.count += other.count
            self.sum += other.sum
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
            for idx, n in other.buckets.items():
                self.buckets[idx] = self.buckets.get(idx, 0) + n

    def as_dict(self) -> dict:
        with self._lock:
            return {
                "count": self.count,
                "sum": self.sum,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                # JSON object keys must be strings
                "buckets": {str(i): n for i, n in sorted(self.buckets.items())},
            }

    @classmethod
    def from_dict(cls, d: Mapping, name: str = "") -> "Histogram":
        h = cls(name)
        h.count = int(d.get("count") or 0)
        h.sum = d.get("sum") or 0.0
        if h.count:
            h.min = d.get("min", 0.0)
            h.max = d.get("max", 0.0)
        raw = d.get("buckets") or {}
        h.buckets = {int(k): int(v) for k, v in raw.items()}
        return h


class MetricsRegistry:
    """Thread-safe bag of named counters, gauges, and histograms."""

    def __init__(self, proc: str = "main") -> None:
        self.proc = proc
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._descriptions: Dict[str, str] = {}

    # -- get-or-create ---------------------------------------------------
    def counter(self, name: str, desc: Optional[str] = None) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            self._describe_locked(name, desc)
            return c

    def gauge(self, name: str, desc: Optional[str] = None) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            self._describe_locked(name, desc)
            return g

    def histogram(self, name: str, desc: Optional[str] = None) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name)
            self._describe_locked(name, desc)
            return h

    # -- descriptions ----------------------------------------------------
    def _describe_locked(self, name: str, desc: Optional[str]) -> None:
        if desc:
            base, _ = split_labels(name)
            self._descriptions.setdefault(base, str(desc))

    def describe(self, name: str, desc: str) -> None:
        """Attach a human-readable description to a metric (keyed by the
        label-free base name). Descriptions ride along in snapshots and
        become Prometheus ``# HELP`` text; first write wins."""
        with self._lock:
            self._describe_locked(name, desc)

    # -- record ----------------------------------------------------------
    def inc(self, name: str, n: int = 1) -> None:
        self.counter(name).inc(n)

    def set_gauge(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    # -- export ----------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            counters = {n: c.value for n, c in self._counters.items()}
            gauges = {n: g.value for n, g in self._gauges.items()}
            hists = list(self._histograms.items())
            descs = dict(self._descriptions)
        out = {
            "schema": SCHEMA,
            "proc": self.proc,
            "counters": dict(sorted(counters.items())),
            "gauges": dict(sorted(gauges.items())),
            "histograms": {n: h.as_dict() for n, h in sorted(hists)},
        }
        # only present when something was described — committed snapshots
        # (BENCH_*.json) stay byte-identical for description-free registries
        if descs:
            out["descriptions"] = dict(sorted(descs.items()))
        return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._descriptions.clear()


def merge_snapshots(snaps: Iterable[Mapping]) -> dict:
    """Merge ``repro.obs/1`` snapshots: counters add, gauges last-write,
    histograms merge exactly by bucket addition."""
    counters: Dict[str, int] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, Histogram] = {}
    descs: Dict[str, str] = {}
    procs: List[str] = []
    for s in snaps:
        if not s:
            continue
        procs.append(str(s.get("proc") or "?"))
        for n, v in (s.get("counters") or {}).items():
            counters[n] = counters.get(n, 0) + int(v)
        for n, v in (s.get("gauges") or {}).items():
            gauges[n] = v
        for n, d in (s.get("histograms") or {}).items():
            h = Histogram.from_dict(d, n)
            if n in hists:
                hists[n].merge(h)
            else:
                hists[n] = h
        for n, d in (s.get("descriptions") or {}).items():
            descs.setdefault(n, str(d))
    out = {
        "schema": SCHEMA,
        "proc": "+".join(procs) if procs else "merged",
        "counters": dict(sorted(counters.items())),
        "gauges": dict(sorted(gauges.items())),
        "histograms": {n: h.as_dict() for n, h in sorted(hists.items())},
    }
    if descs:
        out["descriptions"] = dict(sorted(descs.items()))
    return out


def hist_quantiles(d: Mapping, qs=(0.5, 0.99, 0.999)) -> Dict[str, float]:
    """Convenience: quantiles from a histogram *dict* (snapshot form)."""
    h = Histogram.from_dict(d)
    return {f"p{str(q).replace('0.', '')}": h.quantile(q) for q in qs}


_GLOBAL: Optional[MetricsRegistry] = None
_GLOBAL_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-global registry (created on first use)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = MetricsRegistry(proc="main")
        return _GLOBAL
