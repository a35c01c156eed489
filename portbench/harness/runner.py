"""One run of one cell: set-up, the measured window, the comparison, the
metrics and the result's line.

Set-up builds the cell's inputs from the seed (the pool's scenarios as
the port's requests, m4's weights on the card), then runs each pool
batch once through `run_many`, which captures that batch's program: the
window replays programs and compiles nothing. The window submits one
batch after the other (a sweep's closed loop), cycling through the pool,
and ends with the first pass over the pool that completes after
`seconds`: every call in it is whole, and every pool batch is in it as
often as the others. With a trace the window's passes after the first,
`TRACED_PASSES` of them, run under `torch.profiler`, which the per-layer
metrics read; the calls of the other passes are the untraced ones that
the profiler's cost is read against. After the window the peak
memory is read, the program's state freed, and the reference run over
every pool batch the window used.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import check, gen, lanes, spec, trace as tracing
from . import weights as weights_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACED_PASSES = 2        # passes over the pool profiled in a traced run


@dataclass
class Call:
    pool: int            # index of the pool batch
    start: float         # host clock, seconds
    end: float
    flows: int
    scenarios: int


@dataclass
class Run:
    """What the metrics' readers read."""
    cell: spec.Cell
    setup_s: float
    calls: List[Call]
    batch: int
    num_flows: int                 # flows a scenario (the arena's N)
    num_links: Dict[int, int]      # pool index -> the batch's padded L
    nnz: Dict[int, list]           # pool index -> (flow, link) pairs each
    counts: Dict[int, dict]        # pool index -> the reference's counts
    trace: Optional[tracing.Trace] = None
    traced_calls: List[Call] = field(default_factory=list)

    @property
    def model(self) -> dict:
        return self.cell.config["model"]

    def events(self) -> int:
        """Batched events of the traced calls: 2N a call."""
        return 2 * self.num_flows * len(self.traced_calls)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def execute(cell: spec.Cell, seed: int, seconds: float, traced: bool,
            t_start: float, log=print, device: str = "cuda"):
    """Run `cell`; returns (result dict, checks dict). Raises on a
    failure the run cannot report. `device` is "cuda" but in the tests,
    which drive the rest of a run on the CPU's plain paths."""
    import numpy as np
    import torch

    chips = cell.entry["chips"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < chips):
        raise SystemExit(f"portbench: the cell needs {chips} CUDA "
                         "device(s); none or too few are visible")
    cfg, traffic = cell.config, cell.traffic
    lane = lanes.lane(traffic, cfg)

    # ---- set-up
    pool = gen.pool(cfg, traffic, seed)
    weights = (weights_mod.make(cfg["model"], seed, dev)
               if lane.name == "m4" else None)
    backend = lane.backend(weights, dev)
    reqs = [lanes.requests(batch) for batch in pool]
    for batch in reqs:
        backend.run_many(batch)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    # ---- the window; traced, the passes after the first are profiled
    # (the profiler starts and stops between passes, not inside a call),
    # and the window has that many passes at least
    calls, outs = [], []
    prof = tracing.Profiler() if traced else None
    P = len(reqs)
    traced_span = range(P, (1 + TRACED_PASSES) * P)
    t0 = time.perf_counter()
    i = 0
    while True:
        k = i % P
        if prof and i == traced_span.start:
            prof.start()
        with torch.profiler.record_function(tracing.CALL_SPAN):
            c0 = time.perf_counter()
            res = backend.run_many(reqs[k])
            c1 = time.perf_counter()
        calls.append(Call(pool=k, start=c0, end=c1,
                          flows=sum(len(r.fcts) for r in res),
                          scenarios=len(res)))
        outs.append((k, [np.asarray(r.fcts) for r in res]))
        i += 1
        if prof and i == traced_span.stop:
            s0 = time.perf_counter()
            prof.stop()
            log(f"profiler stopped in {time.perf_counter() - s0:.3f} s")
        # whole passes over the pool, so that every batch weighs alike
        if (i % P == 0 and c1 - t0 >= seconds
                and (not prof or i >= traced_span.stop)):
            break
    log(f"window {calls[-1].end - t0:.3f} s, {len(calls)} calls: "
        + " ".join(f"{c.end - c.start:.4f}" for c in calls) + " s each")
    if traced:
        log(profiler_cost(calls, traced_span))
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    found = forbidden_modules()
    if found:
        raise SystemExit("portbench: the process holds modules of JAX or "
                         f"the JAX package: {found}")

    # ---- free the program, then the reference over the pool batches used
    from repro_torch.core import compiled
    del backend
    compiled.clear_compiled()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    refs, counts = {}, {}
    for k in sorted({c.pool for c in calls}):
        refs[k], counts[k] = lane.reference(pool[k], weights, dev)
    log(f"reference {time.perf_counter() - t_ref:.3f} s")
    nums = check.numbers(outs, refs)
    checks = check.judge(nums, cell.limits)

    run = Run(cell=cell, setup_s=setup_s, calls=calls,
              batch=traffic["batch"], num_flows=traffic["num_flows"],
              num_links={k: max(s.net.num_links for s in b)
                         for k, b in enumerate(pool)},
              nnz={k: [sum(len(p) for p in s.paths) for s in b]
                   for k, b in enumerate(pool)},
              counts=counts)
    if traced:
        s0 = time.perf_counter()
        run.trace = prof.trace()
        run.traced_calls = calls[traced_span.start:traced_span.stop]
        log(f"trace of {len(run.trace.dev_op)} device operations read in "
            f"{time.perf_counter() - s0:.3f} s")
    metrics = {}
    mods = spec.readers(cell.metrics)
    for m in cell.metrics:
        v = mods[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": chips, "memory_peak_bytes": int(peak),
              "power": power_limit() if on_card else None}
    result = {"correct": all(c["ok"] for c in checks.values()),
              "attempted": sum(c.scenarios for c in calls),
              "failed": _failed(outs, refs),
              "metrics": metrics, "device": device}
    if traced:
        tr = run.trace
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        result["breakdown"] = breakdown(tr)
    return result, checks


def profiler_cost(calls: List[Call], traced_span: range) -> str:
    """The profiler's cost on a call: per pool batch, the mean seconds of
    its traced calls against its untraced ones in the same run."""
    parts = []
    for k in sorted({c.pool for c in calls}):
        t = [c.end - c.start for j, c in enumerate(calls)
             if c.pool == k and j in traced_span]
        u = [c.end - c.start for j, c in enumerate(calls)
             if c.pool == k and j not in traced_span]
        if t and u:
            parts.append(f"batch {k}: traced {sum(t) / len(t):.4f} s a "
                         f"call ({len(t)}), untraced {sum(u) / len(u):.4f} "
                         f"s ({len(u)})")
    return "profiler cost: " + "; ".join(parts)


def _failed(outs, refs) -> int:
    """Scenarios of the window that came back without a finite time for
    every flow."""
    import numpy as np
    return sum(b >= len(fcts) or len(fcts[b]) != len(want)
               or not np.isfinite(fcts[b]).all()
               for k, fcts in outs for b, want in enumerate(refs[k]))


def breakdown(tr: tracing.Trace) -> dict:
    """The device operations that took most time, and the longest idle
    gaps labelled by the host operation they fell in."""
    g_s, g_e = tr.gaps()
    longest = sorted(zip(g_e - g_s, g_s, g_e), reverse=True)[:10]
    return {"device_ops": [[n, s] for n, s in tr.by_name()[:10]],
            "idle_gaps": [[tr.host_label(int((s + e) // 2)),
                           float(d) * 1e-9] for d, s, e in longest]}


def line(result: dict, checks: dict) -> str:
    """The result's line, the numbers compared under a key that comes
    last."""
    out = dict(result)
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    return json.dumps(out)
