"""PyTorch profiling hooks: wall time and device memory, per phase.

The port's counterpart of `repro.obs.jaxprof`. :func:`phase` wraps a
named region of work and records, into the process registry and (when
tracing is on) as a span:

* ``phase.<name>.calls`` and the wall-clock seconds ``phase.<name>.wall_s``;
* ``phase.<name>.live_bytes``: the bytes the CUDA caching allocator holds
  for live tensors at phase exit (`live_array_bytes`);
* ``phase.<name>.compiles``: the new compiled programs of the event
  loops (`repro_torch.core.compiled`: a graph capture on a card, a
  prepared eager step on the CPU) that the region built, read from the
  ``TRACE_COUNTS`` families through ``guards.trace_total``; a region that
  built any records its seconds as ``compile_wall_s``, else as
  ``wall_s``, as the JAX package's `jaxprof` does.

`phase` adds no `torch.cuda.synchronize()` of its own: its callers end
on a host copy of their results, which waits for the device.
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from typing import Iterator, Optional

from ..runtime.guards import trace_total
from .registry import MetricsRegistry, get_registry
from .trace import get_tracer


def live_array_bytes() -> int:
    """Bytes of live CUDA tensors (`torch.cuda.memory_allocated()`); 0
    when torch is not imported or CUDA was never initialised."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return 0
    return int(torch.cuda.memory_allocated())


class PhaseStats:
    """Filled in when the ``phase`` block exits."""

    __slots__ = ("name", "wall_s", "compiles", "live_bytes")

    def __init__(self, name: str) -> None:
        self.name = name
        self.wall_s = 0.0
        self.compiles = 0
        self.live_bytes = 0


@contextmanager
def phase(name: str, registry: Optional[MetricsRegistry] = None,
          attrs: Optional[dict] = None) -> Iterator[PhaseStats]:
    """Profile one phase of work; usable whether or not CUDA is up."""
    reg = registry if registry is not None else get_registry()
    tracer = get_tracer()
    stats = PhaseStats(name)
    sp = tracer.span(f"phase:{name}", attrs=attrs)
    c0 = trace_total()
    t0 = time.perf_counter()
    try:
        yield stats
    finally:
        stats.wall_s = time.perf_counter() - t0
        stats.compiles = max(0, trace_total() - c0)
        stats.live_bytes = live_array_bytes()
        reg.inc(f"phase.{name}.calls")
        if stats.compiles:
            reg.inc(f"phase.{name}.compiles", stats.compiles)
            reg.observe(f"phase.{name}.compile_wall_s", stats.wall_s)
        else:
            reg.observe(f"phase.{name}.wall_s", stats.wall_s)
        reg.set_gauge(f"phase.{name}.live_bytes", stats.live_bytes)
        sp.end(compiles=stats.compiles,
               wall_ms=round(stats.wall_s * 1e3, 3),
               live_bytes=stats.live_bytes)
