"""One run of one cell: set-up, the measured window, the comparison, the
metrics and the result's line.

Everything of the cell's own path comes from its lane
(`portbench/lanes/<lane>.py`, `lanes.Lane`). Set-up builds the lane's
inputs and weights from the seed and its backend, then warms it up
(`Lane.warmup`: a call on each pool batch, which captures that batch's
program, or on one where all share their shapes): the window compiles
nothing. The window makes one call after the other (a closed loop),
cycling through the pool, and ends with the first pass over the pool
that completes after `seconds`: every call in it is whole, and every
pool batch is in it as often as the others. With a trace the window's
passes after the first, the lane's `traced_passes` of them, run under
`torch.profiler`, which the per-layer metrics read; the calls of the
other passes are the untraced ones that the profiler's cost is read
against. After the window the peak memory
is read, the program's state freed, and the reference run over every
pool batch the window used.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from . import check, lanes, spec, trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Call:
    pool: int            # index of the pool batch
    start: float         # host clock, seconds
    end: float
    units: int           # work done: flows, tokens
    answers: int         # answers attempted: scenarios, sequences


class Run:
    """What the metrics' readers read: the cell, set-up, the window's
    calls, the reference's counts per pool batch, the trace and its
    calls, and the fields that the cell's lane adds (`Lane.fields`) as
    attributes of their own."""

    def __init__(self, cell: spec.Cell, setup_s: float, calls: List[Call],
                 counts: Dict[int, dict],
                 trace: Optional[tracing.Trace] = None,
                 traced_calls: Optional[List[Call]] = None, **fields):
        self.cell = cell
        self.setup_s = setup_s
        self.calls = calls
        self.counts = counts            # pool index -> the reference's
        self.trace = trace
        self.traced_calls = traced_calls or []
        self.__dict__.update(fields)

    @property
    def model(self) -> dict:
        return self.cell.config["model"]


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
    import torch

    chips = cell.entry["chips"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < chips):
        raise SystemExit(f"portbench: the cell needs {chips} CUDA "
                         "device(s); none or too few are visible")
    traffic = cell.traffic
    lane = lanes.lane(traffic, cell.config, cell.root)

    # ---- set-up
    pool = lane.pool(seed)
    weights = lane.weights(seed, dev)
    backend = lane.backend(weights, dev)
    inputs = [lane.inputs(batch, dev) for batch in pool]
    lane.warmup(backend, inputs)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    # ---- the window; traced, the passes after the first are profiled
    # (the profiler starts and stops between passes, not inside a call),
    # and the window has that many passes at least
    calls, outs = [], []
    prof = tracing.Profiler() if traced else None
    P = len(inputs)
    traced_span = range(P, (1 + lane.traced_passes) * P)
    t0 = time.perf_counter()
    i = 0
    while True:
        k = i % P
        if prof and i == traced_span.start:
            prof.start()
        with torch.profiler.record_function(tracing.CALL_SPAN):
            c0 = time.perf_counter()
            answers, units, attempted = lane.call(backend, inputs[k])
            c1 = time.perf_counter()
        calls.append(Call(pool=k, start=c0, end=c1, units=units,
                          answers=attempted))
        outs.append((k, answers))
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
    lane.release(backend)
    del backend, inputs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    refs, counts = {}, {}
    for k in sorted({c.pool for c in calls}):
        refs[k], counts[k] = lane.reference(pool[k], weights, dev)
    log(f"reference {time.perf_counter() - t_ref:.3f} s")
    checks = check.judge(lane.numbers(outs, refs), cell.limits)

    run = Run(cell=cell, setup_s=setup_s, calls=calls, counts=counts,
              **lane.fields(pool))
    if traced:
        s0 = time.perf_counter()
        run.trace = prof.trace()
        run.traced_calls = calls[traced_span.start:traced_span.stop]
        log(f"trace of {len(run.trace.dev_op)} device operations read in "
            f"{time.perf_counter() - s0:.3f} s")
    metrics = {}
    mods = spec.readers(cell.metrics, cell.root)
    for m in cell.metrics:
        v = mods[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": chips, "memory_peak_bytes": int(peak),
              "power": power_limit() if on_card else None}
    result = {"correct": all(c["ok"] for c in checks.values()),
              "attempted": sum(c.answers for c in calls),
              "failed": lane.failed(outs, refs),
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
