"""SweepRunner — execute a suite of scenarios through one backend.

The port of `repro.scenarios.runner`, in-process: take N declarative
scenarios, materialize them, serve the cache hits, partition the misses
into shape-compatible chunks and push each chunk through
`Backend.run_chunked` -> `run_many`, where `m4` and `flowsim_fast` pad
the chunk to one batch of arenas and run it on their device (one kernel
launch per event step for the whole chunk). A re-run of an overlapping
sweep is pure cache hits and launches nothing. The misses run inside the
obs phase ``sweep.simulate`` (a span when tracing is on, and
``phase.sweep.simulate.*`` in the registry), and a cached run counts
``sweep.cache_hits{backend=...}`` / ``sweep.cache_misses{backend=...}``.
Each chunk is one `run_many`, so at most one compiled program
(`repro_torch.core.compiled`): the misses run under
`no_retrace(allowed=chunks)`, which raises `RetraceError` if a shape or
a static option varied mid-sweep.

What the JAX runner has and this one has not yet: a fleet of worker
processes (`fleet=`) and divergence stamping (`diff_against=`), which
wait for the port's fleet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np

from ..obs.registry import get_registry, labeled
from ..obs.torchprof import phase as obs_phase
from ..runtime.guards import check_result_finite, no_retrace
from ..sim.api import SimRequest, SimResult
from .cache import ResultCache, result_key
from .spec import ScenarioSpec, Sweep


@dataclass
class SweepEntry:
    """One scenario's outcome inside a sweep."""
    spec: ScenarioSpec
    request: SimRequest
    result: SimResult
    cached: bool      # True -> served from the on-disk result cache


@dataclass
class SweepReport:
    """All entries of one sweep run, plus rendering helpers."""
    name: str
    backend: str
    entries: List[SweepEntry]
    wall_time: float      # end-to-end runner time (incl. flow generation)
    simulate_s: float = 0.0   # wall time of the misses' run_chunked

    @property
    def hits(self) -> int:
        """Scenarios served from the on-disk cache."""
        return sum(e.cached for e in self.entries)

    @property
    def misses(self) -> int:
        """Scenarios actually simulated this run."""
        return len(self.entries) - self.hits

    def rows(self) -> List[dict]:
        """Per-scenario summary rows (what the CLI table prints)."""
        out = []
        for e in self.entries:
            s = e.result.slowdowns
            out.append({
                "scenario": e.spec.label,
                "workload": e.spec.workload,
                "flows": e.request.num_flows,
                "cached": e.cached,
                "wall_s": e.result.wall_time,
                "sldn_mean": float(np.nanmean(s)) if len(s) else float("nan"),
                "sldn_p99": float(np.nanpercentile(s, 99)) if len(s)
                else float("nan"),
            })
        return out

    def table(self) -> str:
        """Aligned text table: one row per scenario + a totals footer."""
        rows = self.rows()
        cols = ["scenario", "workload", "flows", "cached", "wall_s",
                "sldn_mean", "sldn_p99"]
        fmt = {"wall_s": "{:.3f}", "sldn_mean": "{:.3f}", "sldn_p99": "{:.2f}"}
        cells = [[fmt.get(c, "{}").format(r[c]) for c in cols] for r in rows]
        widths = [max(len(c), *(len(row[i]) for row in cells))
                  for i, c in enumerate(cols)] if cells else [len(c) for c in cols]
        lines = ["  ".join(c.ljust(w) for c, w in zip(cols, widths))]
        for row in cells:
            lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
        lines.append(f"-- {self.name}: {len(self.entries)} scenarios via "
                     f"{self.backend}, {self.hits} cached / "
                     f"{self.misses} simulated, {self.wall_time:.2f}s total")
        return "\n".join(lines)


class SweepRunner:
    """Run sweeps through one backend with chunked dispatch + result cache.

        runner = SweepRunner(get_backend("flowsim_fast"),
                             cache_dir="results/sweep_cache", chunk_size=8)
        report = runner.run(get_suite("smoke16"))

    chunk_size bounds the padded batch handed to `run_many`; None runs
    the whole sweep as a single chunk. cache_dir=None disables caching
    (timing runs should disable it — a cache hit reports the *cached*
    wall time, not a re-measurement).
    """

    def __init__(self, backend, *, cache_dir: Optional[str] = None,
                 chunk_size: Optional[int] = 8):
        self.backend = backend
        self.cache = ResultCache(cache_dir) if cache_dir else None
        self.chunk_size = chunk_size

    def run(self, sweep: Union[Sweep, Sequence[ScenarioSpec]],
            **request_options) -> SweepReport:
        """Execute every spec; request_options forward to `SimRequest`
        (e.g. seed=, record_events=).

        record_events=True and probes= bypass the cache entirely: cached
        entries carry only fcts/slowdowns, so serving them would silently
        drop the data the caller asked for. Cache keys are request-level
        (hash of the materialized flows), so even a fully-cached re-run
        pays flow generation for every spec.
        """
        specs = list(sweep)
        name = sweep.name if isinstance(sweep, Sweep) else "sweep"
        t0 = time.perf_counter()
        requests = [s.to_request(**request_options) for s in specs]

        results: List[Optional[SimResult]] = [None] * len(specs)
        cached = [False] * len(specs)
        keys = [None] * len(specs)
        use_cache = self.cache is not None \
            and not request_options.get("record_events") \
            and request_options.get("probes") is None
        if use_cache:
            for i, req in enumerate(requests):
                keys[i] = result_key(req, self.backend)
                hit = self.cache.get(keys[i])
                if hit is not None:
                    results[i], cached[i] = hit, True

        miss = [i for i, r in enumerate(results) if r is None]
        if use_cache:
            reg = get_registry()
            reg.inc(labeled("sweep.cache_hits", backend=self.backend.name),
                    len(specs) - len(miss))
            reg.inc(labeled("sweep.cache_misses", backend=self.backend.name),
                    len(miss))
        simulate_s = 0.0
        if miss:
            # each chunk is one run_many = at most one compiled program;
            # more means a static arg or padding shape varied mid-sweep
            chunks = 1 if not self.chunk_size else \
                -(-len(miss) // self.chunk_size)
            with obs_phase("sweep.simulate",
                           attrs={"backend": self.backend.name,
                                  "n": len(miss)}) as ph, \
                    no_retrace(allowed=chunks, label=f"sweep '{name}'"):
                fresh = self.backend.run_chunked([requests[i] for i in miss],
                                                 self.chunk_size)
            simulate_s = ph.wall_s
            for i, res in zip(miss, fresh):
                results[i] = res
                check_result_finite(f"{self.backend.name}:{specs[i].name}",
                                    res)
                if use_cache:
                    self.cache.put(keys[i], res)

        entries = [SweepEntry(spec=s, request=r, result=res, cached=c)
                   for s, r, res, c in zip(specs, requests, results, cached)]
        return SweepReport(name=name, backend=self.backend.name,
                           entries=entries,
                           wall_time=time.perf_counter() - t0,
                           simulate_s=simulate_s)
