"""Fleet run metrics (`repro_torch.fleet.metrics`).

The port's copy of `repro.fleet.metrics`, on the port's registry.
One `FleetMetrics` per `run_fleet` call; the supervisor also writes it
to `<coord>/metrics.json` so CI can gate on `accounted == total` and
archive the JSON as an artifact, plus a `repro.obs/1` snapshot to
`<coord>/obs_snapshot.json` (`Coordinator.write_obs`) so fleet runs
merge into the same telemetry stream as serve/train/perf_gate
(`python -m repro_torch.obs --merge`).

Chunk wall times stream into an obs histogram — the same
log-bucket implementation behind serve's queue-delay tails — so
`chunk_wall_p50_s` / `chunk_wall_p99_s` ride along in the metrics dict
and the histogram itself merges exactly across runs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from ..obs.registry import Histogram, MetricsRegistry

# int counters exported 1:1 into the obs snapshot
_COUNTER_FIELDS = ("total", "done", "already_done", "computed", "poisoned",
                   "retried", "stragglers", "kills", "lease_breaks",
                   "worker_restarts", "workers_spawned", "verify_requeues")


@dataclass
class FleetMetrics:
    """Counters the supervisor accumulates over one fleet run."""
    total: int = 0              # chunks in the task list
    done: int = 0               # chunks with verified results (any run)
    already_done: int = 0       # completed by a *previous* launch
    computed: int = 0           # chunks this launch actually ran
    poisoned: int = 0           # quarantined to the poison manifest
    retried: int = 0            # requeue events (error or reap)
    stragglers: int = 0         # chunks that blew the StepDeadline
    kills: int = 0              # workers the supervisor SIGKILLed
    lease_breaks: int = 0       # stale/dead leases the supervisor broke
    worker_restarts: int = 0    # respawns beyond the initial pool
    workers_spawned: int = 0    # total worker processes ever started
    verify_requeues: int = 0    # done markers retracted (results missing)
    wall_s: float = 0.0
    chaos: str = ""             # the FaultPlan spec, if any
    poison: List[Dict] = field(default_factory=list)
    # completed-chunk wall clock (seconds), mergeable across runs
    chunk_wall: Histogram = field(
        default_factory=lambda: Histogram("fleet.chunk_wall_s"))

    @property
    def accounted(self) -> int:
        """Chunks with a terminal disposition. The CI gate:
        `accounted == total` means nothing fell through the cracks."""
        return self.done + self.poisoned

    def as_dict(self) -> Dict:
        d = {k: getattr(self, k) for k in (
            "total", "done", "already_done", "computed", "poisoned",
            "retried", "stragglers", "kills", "lease_breaks",
            "worker_restarts", "workers_spawned", "verify_requeues",
            "wall_s", "chaos", "poison")}
        d["accounted"] = self.accounted
        d["chunk_wall_p50_s"] = self.chunk_wall.quantile(0.5)
        d["chunk_wall_p99_s"] = self.chunk_wall.quantile(0.99)
        d["chunk_wall_mean_s"] = self.chunk_wall.mean
        return d

    def obs_snapshot(self) -> Dict:
        """This run as a `repro.obs/1` snapshot (counters + the chunk
        wall histogram), mergeable with serve/train/perf_gate output."""
        reg = MetricsRegistry(proc="fleet-supervisor")
        for k in _COUNTER_FIELDS:
            reg.counter("fleet." + k).inc(getattr(self, k))
        reg.set_gauge("fleet.wall_s", self.wall_s)
        snap = reg.snapshot()
        snap["histograms"]["fleet.chunk_wall_s"] = self.chunk_wall.as_dict()
        return snap
