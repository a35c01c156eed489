"""Thread-safe service counters + queue-delay percentiles (the port of
`repro.serve.metrics`; snapshots and Prometheus text are the JAX
package's, key for key).

What the serving layer must be able to answer about itself (the Scalable
Tail Latency Estimation paper's bar — tails, not just means): how much
traffic it absorbed (QPS), how much the content-hash cache deflected
(hit rate), how full the batches ran (occupancy — padding waste is the
price of compile stability), how many compiled programs (CUDA graph
captures on a card) the whole service lifetime cost, and the
p50/p99/p999 of the time requests spent queued waiting for a flush.

The implementation is `repro_torch.obs`: each lane records into a
`MetricsRegistry`, and queue delays stream into the shared log-bucket
`Histogram` instead of the old bounded ring of raw samples — so a
service-lifetime of delays costs O(buckets) memory, p999 is available,
and per-lane snapshots merge *exactly* (bucket addition) rather than
taking a max across lanes. Every snapshot carries its raw registry
state under `"obs"` (schema `repro.obs/1`), which is what the
Prometheus exporter and `python -m repro_torch.obs --merge` consume.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..obs.export import to_prometheus
from ..obs.registry import (
    SCHEMA as OBS_SCHEMA,
    Histogram,
    MetricsRegistry,
    labeled,
)
from ..obs.registry import merge_snapshots as merge_obs_snapshots

# counters every lane maintains; snapshot() reports them all, zero-filled
COUNTERS = ("submitted", "completed", "failed", "rejected", "timed_out",
            "cancelled", "cache_hits", "coalesced", "batches",
            "batched_requests", "padded_requests", "isolated_retries")

_DELAY_HIST = "serve.queue_delay_s"


class ServiceMetrics:
    """Counter block + queue-delay histogram for one dispatch lane."""

    def __init__(self, clock, delay_window: int = 4096):
        # delay_window is kept for API compatibility; the histogram is
        # bounded by construction, no window needed
        self._clock = clock
        self._reg = MetricsRegistry(proc="serve")
        for k in COUNTERS:      # zero-fill so snapshots always carry all
            self._reg.counter("serve." + k)
        self._started = clock.now()

    @property
    def registry(self) -> MetricsRegistry:
        return self._reg

    def count(self, name: str, n: int = 1):
        self._reg.inc("serve." + name, n)

    def observe_queue_delay(self, seconds: float):
        self._reg.observe(_DELAY_HIST, seconds)

    def snapshot(self, compiles: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 dispatcher_alive: Optional[bool] = None) -> dict:
        """One JSON-able dict: counters + derived rates + delay tails."""
        if queue_depth is not None:
            self._reg.set_gauge("serve.queue_depth", queue_depth)
        if dispatcher_alive is not None:
            self._reg.set_gauge("serve.dispatcher_alive",
                                1.0 if dispatcher_alive else 0.0)
        obs = self._reg.snapshot()
        counters = obs.get("counters") or {}
        counts = {k: counters.get("serve." + k, 0) for k in COUNTERS}
        elapsed = max(self._clock.now() - self._started, 1e-9)
        out = dict(counts)
        out["uptime_s"] = elapsed
        out["qps"] = counts["completed"] / elapsed
        out["cache_hit_rate"] = (
            counts["cache_hits"] / counts["submitted"]
            if counts["submitted"] else 0.0)
        out["batch_occupancy"] = (
            counts["batched_requests"] /
            (counts["batched_requests"] + counts["padded_requests"])
            if counts["batched_requests"] else 0.0)
        h = self._reg.histogram(_DELAY_HIST)
        out["queue_delay_p50_ms"] = h.quantile(0.5) * 1e3
        out["queue_delay_p99_ms"] = h.quantile(0.99) * 1e3
        out["queue_delay_p999_ms"] = h.quantile(0.999) * 1e3
        out["queue_delay_mean_ms"] = h.mean * 1e3
        if queue_depth is not None:
            out["queue_depth"] = queue_depth
        if dispatcher_alive is not None:
            out["dispatcher_alive"] = bool(dispatcher_alive)
        if compiles is not None:
            out["compiles"] = compiles
        out["obs"] = obs
        return out


def merge_snapshots(per_lane: Dict[str, dict]) -> dict:
    """Aggregate lane snapshots into one service-level block (counters
    sum; rates recomputed from the sums; delay tails recomputed from the
    *merged* histograms when the lanes carry `obs` state, falling back
    to a conservative max across lanes otherwise)."""
    agg: dict = {k: 0 for k in COUNTERS}
    for snap in per_lane.values():
        for k in COUNTERS:
            agg[k] += snap.get(k, 0)
    agg["uptime_s"] = max((s.get("uptime_s", 0.0)
                           for s in per_lane.values()), default=0.0)
    agg["qps"] = sum(s.get("qps", 0.0) for s in per_lane.values())
    agg["cache_hit_rate"] = (agg["cache_hits"] / agg["submitted"]
                             if agg["submitted"] else 0.0)
    agg["batch_occupancy"] = (
        agg["batched_requests"] /
        (agg["batched_requests"] + agg["padded_requests"])
        if agg["batched_requests"] else 0.0)
    obs_snaps = [s.get("obs") for s in per_lane.values() if s.get("obs")]
    merged_obs = merge_obs_snapshots(obs_snaps) if obs_snaps else None
    delay_d = ((merged_obs.get("histograms") or {}).get(_DELAY_HIST)
               if merged_obs else None)
    if delay_d and delay_d.get("count"):
        h = Histogram.from_dict(delay_d, _DELAY_HIST)
        agg["queue_delay_p50_ms"] = h.quantile(0.5) * 1e3
        agg["queue_delay_p99_ms"] = h.quantile(0.99) * 1e3
        agg["queue_delay_p999_ms"] = h.quantile(0.999) * 1e3
        agg["queue_delay_mean_ms"] = h.mean * 1e3
    else:
        for q in ("queue_delay_p50_ms", "queue_delay_p99_ms",
                  "queue_delay_p999_ms", "queue_delay_mean_ms"):
            agg[q] = max((s.get(q, 0.0) for s in per_lane.values()),
                         default=0.0)
    if any("queue_depth" in s for s in per_lane.values()):
        agg["queue_depth"] = sum(s.get("queue_depth", 0)
                                 for s in per_lane.values())
    compiles = [s["compiles"] for s in per_lane.values() if "compiles" in s]
    if compiles:
        agg["compiles"] = max(compiles)
    if merged_obs is not None:
        agg["obs"] = merged_obs
    return agg


def prometheus_text(agg: dict) -> str:
    """Render a `SimService.metrics()` aggregate (with its per-lane
    breakdown) as Prometheus text format: per-lane series carry a
    `lane` label, service-level series none."""
    snap: dict = {"schema": OBS_SCHEMA, "proc": "serve",
                  "counters": {}, "gauges": {}, "histograms": {}}
    lanes = agg.get("lanes") or {}
    for lname in sorted(lanes):
        s = lanes[lname]
        for k in COUNTERS:
            snap["counters"][labeled("serve." + k, lane=lname)] = \
                s.get(k, 0)
        for g in ("queue_depth", "qps", "cache_hit_rate",
                  "batch_occupancy"):
            if g in s:
                snap["gauges"][labeled("serve." + g, lane=lname)] = \
                    s.get(g) or 0.0
        if "dispatcher_alive" in s:
            snap["gauges"][labeled("serve.dispatcher_alive", lane=lname)] \
                = 1.0 if s.get("dispatcher_alive") else 0.0
        lane_obs = s.get("obs") or {}
        delay_d = (lane_obs.get("histograms") or {}).get(_DELAY_HIST)
        if delay_d:
            snap["histograms"][labeled(_DELAY_HIST, lane=lname)] = delay_d
    for k in COUNTERS:
        snap["counters"]["serve." + k] = agg.get(k, 0)
    for g in ("qps", "cache_hit_rate", "batch_occupancy", "uptime_s",
              "compiles", "queue_depth"):
        if g in agg:
            snap["gauges"]["serve." + g] = agg.get(g) or 0.0
    agg_obs = agg.get("obs") or {}
    delay_d = (agg_obs.get("histograms") or {}).get(_DELAY_HIST)
    if delay_d:
        snap["histograms"][_DELAY_HIST] = delay_d
    return to_prometheus(snap)
