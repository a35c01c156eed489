"""SweepRunner — execute a suite of scenarios through one backend.

The port of `repro.scenarios.runner`: take N declarative
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
a static option varied mid-sweep. With `fleet=FleetConfig(...)` the
misses go to supervised worker processes instead (`repro_torch.fleet`),
chunked the same way, so the cache ends bitwise as an in-process run
leaves it; `diff_against=` stamps each fleet task's done marker with
per-scenario divergence from an oracle's cached results.
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
    """One scenario's outcome inside a sweep. `result` is None only for
    scenarios whose fleet chunk was poisoned (quarantined after a
    deterministic failure — see `SweepReport.fleet`)."""
    spec: ScenarioSpec
    request: SimRequest
    result: Optional[SimResult]
    cached: bool      # True -> served from the on-disk result cache


@dataclass
class SweepReport:
    """All entries of one sweep run, plus rendering helpers."""
    name: str
    backend: str
    entries: List[SweepEntry]
    wall_time: float      # end-to-end runner time (incl. flow generation)
    simulate_s: float = 0.0   # wall time of the misses' run_chunked (or
    #                           of their fleet run)
    fleet: Optional[dict] = None   # FleetMetrics.as_dict() of a fleet run

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
            s = e.result.slowdowns if e.result is not None else []
            out.append({
                "scenario": e.spec.label,
                "workload": e.spec.workload,
                "flows": e.request.num_flows,
                "cached": e.cached,
                "wall_s": e.result.wall_time if e.result is not None
                else float("nan"),
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

    fleet=FleetConfig(...) shards cache misses across supervised worker
    processes (`repro_torch.fleet`) instead of running them in-process:
    workers claim chunks via lease files, write through this runner's
    cache, and survive crashes, stragglers and poison chunks. Fleet mode
    requires a cache_dir (the cache *is* the result channel) and keeps
    the chunking of `run_chunked`, so fleet and in-process runs of the
    same sweep fill identical cache entries. On the card each worker
    has its own CUDA context on the same card.
    """

    def __init__(self, backend, *, cache_dir: Optional[str] = None,
                 chunk_size: Optional[int] = 8, fleet=None,
                 diff_against=None):
        if fleet is not None and cache_dir is None:
            raise ValueError("fleet mode needs a cache_dir: workers hand "
                             "results back through the result cache")
        self.backend = backend
        self.cache = ResultCache(cache_dir) if cache_dir else None
        self.chunk_size = chunk_size
        self.fleet = fleet
        # oracle backend (or its fingerprint string) for fleet runs: each
        # task's done marker gets stamped with per-scenario divergence vs
        # the oracle's cached results (see repro_torch.obs.diff)
        self.diff_against = diff_against

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
        fleet_metrics = None
        if miss and self.fleet is not None and use_cache:
            t_fleet = time.perf_counter()
            fleet_metrics = self._run_fleet(name, specs, requests, keys,
                                            miss, results, request_options)
            simulate_s = time.perf_counter() - t_fleet
        elif miss:
            if self.fleet is not None:
                # record_events/probes bypass the cache, and the cache is
                # the fleet's only result channel
                raise ValueError("fleet mode cannot serve "
                                 "record_events=True or probes= (results "
                                 "round-trip through the cache, which drops "
                                 "events and probe series)")
            simulate_s = self._run_inline(name, specs, requests, keys, miss,
                                          results, use_cache)

        entries = [SweepEntry(spec=s, request=r, result=res, cached=c)
                   for s, r, res, c in zip(specs, requests, results, cached)]
        return SweepReport(name=name, backend=self.backend.name,
                           entries=entries,
                           wall_time=time.perf_counter() - t0,
                           simulate_s=simulate_s, fleet=fleet_metrics)

    def _run_inline(self, name, specs, requests, keys, miss, results,
                    use_cache) -> float:
        """Run the misses in this process through `run_chunked`; fills
        `results` (and the cache) in place, returns the simulate wall."""
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
        for i, res in zip(miss, fresh):
            results[i] = res
            check_result_finite(f"{self.backend.name}:{specs[i].name}", res)
            if use_cache:
                self.cache.put(keys[i], res)
        return ph.wall_s

    def _run_fleet(self, name, specs, requests, keys, miss, results,
                   request_options):
        """Dispatch the cache misses through a supervised worker fleet;
        fills `results` in place from the cache afterwards and returns
        the run's metrics dict. Scenarios whose chunk was poisoned stay
        None. Falls back to the in-process path, on the same backend and
        device, when spawn workers can't start (no importable __main__ —
        stdin/REPL parents)."""
        from ..fleet import default_coord_dir, run_fleet, sweep_job_for, \
            sweep_tasks
        from ..train.data import _pool_usable
        if not _pool_usable():
            self._run_inline(name, specs, requests, keys, miss, results,
                             True)
            return None
        oracle_fp = self.diff_against
        if oracle_fp is not None and hasattr(oracle_fp, "fingerprint"):
            oracle_fp = oracle_fp.fingerprint()
        job = sweep_job_for(self.backend, self.cache.root,
                            request_options=request_options,
                            diff_against=oracle_fp)
        tasks = sweep_tasks([specs[i] for i in miss],
                            [requests[i] for i in miss],
                            [keys[i] for i in miss], self.chunk_size)
        config = self.fleet
        if config.coord_dir is None:
            config = config.with_coord_dir(
                default_coord_dir(self.cache.root, tasks))
        metrics = run_fleet(tasks, job, config)
        for i in miss:
            res = self.cache.get(keys[i])
            if res is not None:
                check_result_finite(f"{self.backend.name}:{specs[i].name}",
                                    res)
            results[i] = res
        return metrics.as_dict()
