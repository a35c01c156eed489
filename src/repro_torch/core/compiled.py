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
- **Sharded calls** (`run_sharded`, JAX's pmap paths): one call runs
  each shard through the entry of its own device, in turn, and counts
  one in `TRACE_COUNTS` when any of those entries is new, as JAX counts
  one pmap trace for all its devices. Shards on one device share that
  device's entry; a program's `result()` returns copies, so a shard's
  outputs survive the next shard's load.
- **Launch counters.** A replay runs no Python, so the kernel wrappers'
  `.launches` cannot count it: an entry records how many launches of
  each kind its graphs hold and adds them per replay. The warm-up and
  the capture do not count.

The training step (`StepCache`, `StepProgram`) follows the same rules
with one difference of ownership. JAX's jit cache of a training step
belongs to the jitted function that one `fit` call (or one
`make_train_step` call) makes, so a `StepCache` belongs to that step
function and is dropped with it: a full-width training graph's pool
holds the whole step's activations, and a process-wide entry left behind
by each `fit` would fill the card. The live caches are reachable through
a weak registry, so `entries()` reports them and `clear_compiled()`
drops their programs. A training program runs with autograd on: on a
card its graph holds one whole update (forward, backward, clipping and
AdamW, written in place into the program's buffers), and all the
programs of one cache share one pool (they never run at once).

**Spans** (`repro_torch.obs.trace`, off unless a trace directory is set
or the profiler records): each shard of a call is a `compiled.run`
(attributes `entry`, `device`, `new`), holding `compiled.load`,
`compiled.capture` on an entry's first call on a card (`graphs`,
`pool_bytes`) and `compiled.replay` (`replays`: graph launches, or eager
steps on the CPU). They time the host: the replays' wait for the device
shows in the span that copies the results back.

`eager()` runs the loops and the training steps without the cache, as
plain eager calls on any device: the comparison of a captured program
with its eager twin on the card uses it, and nothing else should.
`clear_compiled()` drops every entry (the counterpart of
`jax.clear_caches`); `entries()` reports them.
"""
from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..obs.trace import get_tracer

# every run goes through one lock: entries are process-wide, and the GNN
# kernel's grid barrier allows one launch per card at a time
_LOCK = threading.RLock()
_CACHE: Dict[tuple, "Entry"] = {}
_STEP_CACHES: "weakref.WeakSet[StepCache]" = weakref.WeakSet()
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


def _warm_up(dev: torch.device, fn: Callable[[], object]) -> None:
    """Run `fn` once on a side stream, so that what it sets up lazily
    (library handles and workspaces, the allocator's blocks) is not met
    inside a capture; wait for it and release the blocks it cached."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()


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
        prog, tracer = self.program, get_tracer()
        with tracer.span("compiled.load"):
            prog.load(*args)
        replays = sum(times for _, times in prog.plan)
        if self.device.type == "cuda":
            # the capture stream is the current device's: a shard's entry
            # on another card captures and replays there
            with torch.cuda.device(self.device):
                if not self.graphs:
                    with tracer.span("compiled.capture") as sp:
                        self._capture()
                        sp.attr("graphs", len(self.graphs))
                        sp.attr("pool_bytes", self.pool_bytes)
                    with tracer.span("compiled.load"):
                        prog.load(*args)  # the warm-up advanced the state
                with tracer.span("compiled.replay", attrs={
                        "replays": replays}):
                    for name, times in prog.plan:
                        graph = self.graphs[name]
                        for _ in range(times):
                            graph.replay()
                        for fn, n in self.launches[name].items():
                            fn.launches += n * times
        else:
            with tracer.span("compiled.replay", attrs={"replays": replays}):
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
        _warm_up(dev, lambda: [prog.steps[name]() for name, _ in prog.plan])
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
    return run_sharded(counts, name, key, build, [(device, args)])[0]


def run_sharded(counts, name: str, key: tuple, build: Callable[..., Program],
                shards) -> List[tuple]:
    """One call of entry point `name` over `shards`, a list of (device,
    args): shard i runs through the entry of (name, key, its device), in
    turn, and its result (copies: a `Program`'s `result()` clones) stays
    on its device. `counts[name]` moves by one when any of these entries
    is new, once per call as JAX counts one pmap trace however many
    devices it spans; shards on one device share that device's entry.
    Under `eager()` each shard's program is built afresh and run
    eagerly."""
    with _LOCK, torch.inference_mode():
        if getattr(_EAGER, "on", False):
            out = []
            for _, args in shards:
                prog = build(*args)
                prog.load(*args)
                prog.run_eager()
                out.append(prog.result())
            return out
        fulls = [(name,) + tuple(key) + (str(torch.device(dev)),)
                 for dev, _ in shards]
        if any(full not in _CACHE for full in fulls):
            counts[name] += 1
        tracer, out = get_tracer(), []
        for full, (dev, args) in zip(fulls, shards):
            with tracer.span("compiled.run", attrs={
                    "entry": name, "device": full[-1],
                    "new": full not in _CACHE}):
                out.append(_run_entry(full, torch.device(dev), build, args))
        return out


def _run_entry(full: tuple, device: torch.device, build, args) -> tuple:
    """Run `args` through the entry of key `full`, building it (and
    dropping it again if its first run raises) when it is new."""
    entry = _CACHE.get(full)
    if entry is not None:
        return entry.run(*args)
    entry = Entry(full, build(*args), device)
    _CACHE[full] = entry
    try:
        return entry.run(*args)
    except BaseException:
        del _CACHE[full]
        raise


class StepProgram:
    """What a training entry runs, built by the training module for one
    key. `load(*args)` copies one call's inputs (weights, moments, the
    bucket's arrays) into the buffers the program owns and resets its
    counters, eagerly and outside any graph; `body()` applies one update
    in place on those buffers (the work a graph captures: no host scalar,
    no `.item()`); `replays` bodies make one call (the sims of a per-sim
    bucket); `result()` returns copies of what the call returns, so no
    caller ever holds a buffer a later call writes."""

    def __init__(self, *, load: Callable[..., None], body: Callable[[], None],
                 result: Callable[[], tuple], replays: int, buffers=()):
        self.load, self.body, self.result = load, body, result
        self.replays = replays
        self.buffers = list(buffers)

    def run_eager(self) -> None:
        for _ in range(self.replays):
            self.body()


class StepEntry:
    """One key's training program, and on a card its graph, captured
    into `pool`. The walls of its compile (warm-up, capture,
    instantiation) are kept for `entries()`."""

    def __init__(self, key: tuple, program: StepProgram,
                 device: torch.device, pool=None):
        self.key, self.program, self.device = key, program, device
        self.pool = pool
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.pool_bytes = 0
        self.buffer_bytes = sum(t.numel() * t.element_size()
                                for t in program.buffers)
        self.walls: Dict[str, float] = {}
        self.calls = 0

    def run(self, *args) -> tuple:
        prog = self.program
        prog.load(*args)
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                if self.graph is None:
                    self._capture()
                    prog.load(*args)    # the warm-up trained the buffers
                for _ in range(prog.replays):
                    self.graph.replay()
        else:
            prog.run_eager()
        self.calls += 1
        return prog.result()

    def _capture(self) -> None:
        """Warm the update up once on a side stream, then capture it into
        a graph in the pool. A failed capture raises."""
        prog, dev = self.program, self.device
        t0 = time.perf_counter()
        _warm_up(dev, prog.body)
        t1 = time.perf_counter()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool,
                              capture_error_mode="thread_local"):
            prog.body()
            t2 = time.perf_counter()
        torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        self.graph = graph
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.walls = {"warmup_s": t1 - t0, "capture_s": t2 - t1,
                      "instantiate_s": t3 - t2}

    def report(self) -> dict:
        return {"entry": self.key[0], "device": str(self.device),
                "graphs": ["update"] if self.graph is not None else [],
                "calls": self.calls, "replays_per_call": self.program.replays,
                "pool_bytes": self.pool_bytes,
                "buffer_bytes": self.buffer_bytes, **self.walls}


class StepCache:
    """The compiled programs of one training step function, keyed like
    JAX's jit of it (the shapes and dtypes of the call's arrays, and the
    device). Each new program counts one in `counts[name]`; on a card it
    is captured on first use, and every program of the cache shares one
    graph pool. Dropped with its step function; one call runs at a time
    (the programs own their buffers)."""

    def __init__(self, counts, name: str):
        self.counts, self.name = counts, name
        self.entries: Dict[tuple, StepEntry] = {}
        self.pool = None
        self.lock = threading.Lock()
        with _LOCK:
            _STEP_CACHES.add(self)

    def run(self, key: tuple, device, build: Callable[..., StepProgram],
            *args) -> tuple:
        """Run one call through `key`'s program: built by `build(*args)`
        and counted on first use, then loaded with `args` and run (on a
        card: replayed). Under `eager()` the program is built afresh, run
        eagerly and not cached."""
        device = torch.device(device)
        if getattr(_EAGER, "on", False):
            prog = build(*args)
            prog.load(*args)
            prog.run_eager()
            return prog.result()
        full = (self.name,) + tuple(key) + (str(device),)
        with self.lock:
            entry = self.entries.get(full)
            if entry is not None:
                return entry.run(*args)
            self.counts[self.name] += 1
            if device.type == "cuda" and self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            entry = StepEntry(full, build(*args), device, self.pool)
            self.entries[full] = entry
            try:
                return entry.run(*args)
            except BaseException:
                del self.entries[full]
                raise

    def clear(self) -> None:
        with self.lock:
            self.entries.clear()
            self.pool = None


@contextlib.contextmanager
def eager():
    """Run the loops and training steps of this thread eagerly and
    uncached, on any device: for comparing a captured program with its
    eager twin only."""
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
        for cache in list(_STEP_CACHES):
            cache.clear()


def entries() -> List[dict]:
    """One report per live entry: its entry point, device, graphs, calls,
    the bytes of its graph pool and of its own buffers (a training entry
    also its replays per call and its compile walls)."""
    with _LOCK:
        return [e.report() for e in _CACHE.values()] + [
            e.report() for cache in list(_STEP_CACHES)
            for e in cache.entries.values()]
