"""The port's own spans on the profiler's timeline, as the per-layer
metrics of its host layers read them.

Inside each `run_many` the port opens `torch.profiler` ranges named
`sim.*` and `compiled.*` (`repro_torch.obs.trace`: `sim.run_many`
around the call, `sim.prep`, `sim.upload`, `sim.incidence`,
`sim.readback` and `sim.results` below it, `compiled.run` and its load,
capture and replay), which `trace.reduce` keeps among the host records,
on the clock of the device's operations. A span's self time is its
duration less the part that the program's spans inside it cover.
"""
from __future__ import annotations

PROGRAM = ("sim.", "compiled.")      # the names of the port's spans


def program_has_spans() -> bool:
    """Whether the port opens its spans on the profiler's timeline: one
    that does not has no `repro_torch.obs.trace.profiling`, and the
    metrics that read its spans read nothing there."""
    try:
        from repro_torch.obs import trace
    except ImportError:
        return False
    return hasattr(trace, "profiling")


def _covered(pieces) -> int:
    """Nanoseconds that the union of (start, end) `pieces` covers."""
    total, reach = 0, None
    for s, e in sorted(pieces):
        if reach is None or s > reach:
            total += e - s
            reach = e
        elif e > reach:
            total += e - reach
            reach = e
    return total


def self_ms(run, name: str):
    """Milliseconds of self time a traced call spends in the spans named
    `name` whose start lies inside one of the trace's calls, summed and
    averaged over the traced calls: 0.0 where none ran, None without a
    trace or where the port opens no spans."""
    tr = run.trace
    if tr is None or not run.traced_calls or not program_has_spans():
        return None
    prog = [(i, s, e) for i, (s, e, n) in enumerate(tr.host)
            if n.startswith(PROGRAM)]
    total = 0
    for i, (s, e, n) in enumerate(tr.host):
        if n != name or not any(c0 <= s <= c1 for c0, c1 in tr.calls):
            continue
        inner = [(a, b) for j, a, b in prog if j != i and s <= a and b <= e]
        total += (e - s) - _covered(inner)
    return total / len(run.traced_calls) * 1e-6
