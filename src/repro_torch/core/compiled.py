"""One compiled program per arena shape: the port's `jax.jit` cache for
the two inference event loops (m4's open loop and flowsim_fast).

The JAX package runs each loop as one `lax.scan` under `jax.jit`, which
compiles once per static key (the entry point, the config, every arena
shape, the static options) and counts each compile in its module's
`TRACE_COUNTS`. The port keeps the same cache, keyed alike:

- **The key** is the entry point's name plus what the JAX jit keys on:
  the config, `num_links`, every arena shape, the snapshot program,
  `num_events`, the `ProbeConfig` and the device. The weights' values
  are not in it: a call copies its weights, arenas and arrival schedule
  into the entry's own input tensors (`copy_`), as JAX passes `params` as
  a traced argument.
- **An entry** holds a `Program`: the buffers it owns (inputs and the
  carried state, updated in place) and its steps. On a card each step is
  captured once as a CUDA graph (after a warm-up on a side stream), all
  of an entry's graphs in one memory pool; a call resets the state and
  replays the plan, one graph launch per event (a probed entry replays
  `stride` events per launch). On the CPU the entry holds the same
  prepared steps and runs them eagerly.
- **`TRACE_COUNTS`** of the loop's module moves by one for each new
  entry, under the JAX package's key names, so on either device the
  counts move where JAX's do, and `runtime.guards.no_retrace` guards them
  as it guards XLA compiles.
- **Launch counters.** A replay runs no Python, so the kernel wrappers'
  `.launches` cannot count it: an entry records how many launches of
  each kind its graphs hold and adds them per replay. The warm-up and
  the capture do not count.

`eager()` runs the loops without the cache, as plain eager calls on any
device: the comparison of a captured loop with its eager twin on the
card uses it, and nothing else should. `clear_compiled()` drops every
entry (the counterpart of `jax.clear_caches`); `entries()` reports them.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch

# every run goes through one lock: entries are process-wide, and the GNN
# kernel's grid barrier allows one launch per card at a time
_LOCK = threading.RLock()
_CACHE: Dict[tuple, "Entry"] = {}
_EAGER = threading.local()


class Program:
    """What an entry runs, built by the loop's module for one key.

    `load(*args)` copies one call's inputs into the buffers the program
    owns and resets its carried state (eagerly, outside any graph).
    `event()` advances every scenario by one event in place and returns
    the event's times (B,); `sample(t_ev)` writes one probe sample (None
    when probes are off). `length` events make one call, and the steps
    follow from them: "event" (one event) replayed `length` times, or,
    with probes every `stride` events, "group" (an event, its sample,
    `stride - 1` events) replayed `length // stride` times and "tail" (the
    same over the `length % stride` events left) once. `result()` returns
    copies of the outputs; `buffers` are the tensors the program owns."""

    def __init__(self, *, load: Callable[..., None],
                 event: Callable[[], torch.Tensor],
                 result: Callable[[], tuple], length: int,
                 sample: Optional[Callable[[torch.Tensor], None]] = None,
                 stride: Optional[int] = None, buffers=()):
        self.load, self.event, self.sample = load, event, sample
        self.result = result
        self.buffers = list(buffers)
        self.steps: Dict[str, Callable[[], None]] = {}
        self.plan: List[Tuple[str, int]] = []
        if sample is None:
            if length:
                self.steps["event"] = self._events(0)
                self.plan.append(("event", length))
            return
        q, r = divmod(length, stride)
        for name, n, times in (("group", stride, q), ("tail", r, 1)):
            if n and times:
                self.steps[name] = self._events(n)
                self.plan.append((name, times))

    def _events(self, n: int) -> Callable[[], None]:
        """One event, or (n > 0) an event, its sample and n - 1 more."""
        if not n:
            return self.event

        def step():
            self.sample(self.event())
            for _ in range(n - 1):
                self.event()
        return step

    def run_eager(self) -> None:
        for name, times in self.plan:
            step = self.steps[name]
            for _ in range(times):
                step()


def _launch_counters():
    """The kernel wrappers whose `.launches` a replay must advance."""
    from ..kernels.bipartite.ops import bipartite_round
    from ..kernels.fused_gru.ops import gru_pair
    from ..kernels.waterfill.ops import masked_rowmin, waterfill_event
    return (gru_pair, bipartite_round, waterfill_event, masked_rowmin)


class Entry:
    """One key's program, and on a card its graphs and their pool."""

    def __init__(self, key: tuple, program: Program, device: torch.device):
        self.key, self.program, self.device = key, program, device
        self.graphs: Dict[str, "torch.cuda.CUDAGraph"] = {}
        self.launches: Dict[str, Dict[Callable, int]] = {}
        self.pool_bytes = 0
        self.buffer_bytes = sum(t.numel() * t.element_size()
                                for t in program.buffers)
        self.calls = 0

    def run(self, *args) -> tuple:
        prog = self.program
        prog.load(*args)
        if self.device.type == "cuda":
            if not self.graphs:
                self._capture()
                prog.load(*args)        # the warm-up advanced the state
            for name, times in prog.plan:
                graph = self.graphs[name]
                for _ in range(times):
                    graph.replay()
                for fn, n in self.launches[name].items():
                    fn.launches += n * times
        else:
            prog.run_eager()
        self.calls += 1
        return prog.result()

    def _capture(self) -> None:
        """Warm each step up on a side stream, then capture it into a
        graph; every graph of the entry shares one pool. The launch
        counters come back to where they were."""
        prog, dev = self.program, self.device
        counters = _launch_counters()
        saved = [fn.launches for fn in counters]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for name, _ in prog.plan:
                prog.steps[name]()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        pool = torch.cuda.graph_pool_handle()
        try:
            for name, _ in prog.plan:
                marks = [fn.launches for fn in counters]
                graph = torch.cuda.CUDAGraph()
                # thread_local: CUDA calls of other threads (a service's
                # HTTP and dispatcher threads) cannot void the capture
                with torch.cuda.graph(graph, pool=pool,
                                      capture_error_mode="thread_local"):
                    prog.steps[name]()
                self.graphs[name] = graph
                self.launches[name] = {
                    fn: fn.launches - m for fn, m in zip(counters, marks)
                    if fn.launches != m}
        finally:
            for fn, n in zip(counters, saved):
                fn.launches = n
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def report(self) -> dict:
        return {"entry": self.key[0], "device": str(self.device),
                "graphs": sorted(self.graphs), "calls": self.calls,
                "pool_bytes": self.pool_bytes,
                "buffer_bytes": self.buffer_bytes}


def run(counts, name: str, key: tuple, device, build: Callable[..., Program],
        *args) -> tuple:
    """Run one call of entry point `name` through its key's entry: built
    by `build(*args)`, counted in `counts[name]`, and (on a card)
    captured on first use; then loaded with `args` and replayed. Under
    `eager()` the program is built afresh, run eagerly and not cached."""
    device = torch.device(device)
    with _LOCK, torch.inference_mode():
        if getattr(_EAGER, "on", False):
            prog = build(*args)
            prog.load(*args)
            prog.run_eager()
            return prog.result()
        full = (name,) + tuple(key) + (str(device),)
        entry = _CACHE.get(full)
        if entry is None:
            counts[name] += 1
            entry = Entry(full, build(*args), device)
            _CACHE[full] = entry
            try:
                return entry.run(*args)
            except BaseException:
                del _CACHE[full]
                raise
        return entry.run(*args)


@contextlib.contextmanager
def eager():
    """Run the loops of this thread eagerly and uncached, on any device:
    for comparing a captured loop with its eager twin only."""
    prev = getattr(_EAGER, "on", False)
    _EAGER.on = True
    try:
        yield
    finally:
        _EAGER.on = prev


def clear_compiled() -> None:
    """Drop every entry with its buffers and graphs (`jax.clear_caches`).
    The `TRACE_COUNTS` stay as they are, as JAX's do."""
    with _LOCK:
        _CACHE.clear()


def entries() -> List[dict]:
    """One report per live entry: its entry point, device, graphs, calls,
    the bytes of its graph pool and of its own buffers."""
    with _LOCK:
        return [e.report() for e in _CACHE.values()]
