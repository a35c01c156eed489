"""`SimService` — the always-on simulation front door (the port of
`repro.serve.service`).

Everything the batch path already has — the content-hash result cache
(`repro_torch.scenarios.ResultCache`), shape-bucketed `run_many` with one
compiled program per arena shape (`repro_torch.core.compiled`: a captured
CUDA graph on a card), the compile and NaN guards
(`repro_torch.runtime.guards`) — lifted into a long-lived process that
many clients hit concurrently:

    service = SimService(get_backend("flowsim_fast"),
                         cache_dir="results/serve_cache")
    future = service.submit(request)          # thread-safe, returns fast
    result = future.result()                  # a repro_torch.sim.SimResult
    service.close()                           # drains in-flight batches

Design (the JAX package's docs/SERVING.md):

- **Dynamic batching.** Misses queue into buckets keyed by exact arena
  shape `(num_flows, num_links)`; a dispatcher thread per backend flushes
  a bucket when it holds `batch_size` requests or its oldest entry is
  `flush_interval_s` old, whichever first. Flushed batches are padded to
  `batch_size` with a copy of an already-present request, so every flush
  of a bucket presents the *same* stacked arena shape to `run_many` —
  one compiled program per bucket for the lifetime of the process,
  enforced with `no_retrace(allowed=0)` once a shape has compiled. (m4's
  link-degree axis is part of its arena shape but not of the bucket key:
  a later flush of a bucket whose padded degree differs compiles anew,
  breaks that budget and is isolated, as in the JAX package.)
- **Coalescing.** Duplicate in-flight requests (same `content_hash` ×
  backend fingerprint, i.e. the sweep-cache key) attach to one pending
  simulation; completed results are also written back to the shared
  cache so repeat traffic short-circuits at submit time.
- **Backpressure.** Queues are bounded (`max_queue` per backend lane):
  when full, `submit` raises `ServiceOverloaded` carrying a retry-after
  hint instead of growing without bound — the caller sheds load, the
  service never deadlocks.
- **Deadlines.** `submit(..., timeout=s)` bounds *queue* time: requests
  still waiting when their deadline passes fail with `RequestTimeout`
  without poisoning the batch they would have joined.
- **Graceful shutdown.** `close(drain=True)` stops admission, flushes
  every queued bucket (deadline rules suspended), resolves all futures,
  then joins the dispatchers. `drain=False` fails queued futures with
  `ServiceClosed` instead. Either way nothing hangs and nothing is
  silently dropped.

Time is injectable (`serve.clock`): the test suite drives every deadline
decision through a `ManualClock`, so flush behavior is asserted without a
single wall-clock sleep.
"""
from __future__ import annotations

import hashlib
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple, Union

from ..obs.trace import NULL_SPAN, get_tracer
from ..runtime.guards import (NonFiniteError, check_result_finite,
                              no_retrace, trace_total)
from ..scenarios.cache import ResultCache, result_key
from ..sim import Backend, SimRequest, SimResult
from .clock import Clock, MonotonicClock
from .metrics import ServiceMetrics, merge_snapshots


def retry_after_jitter(base_s: float, key: str) -> float:
    """Deterministic retry-after hint in [base, 2*base).

    The jitter fraction is hashed from the request's cache key, so a
    cohort of synchronized clients rejected on the same tick gets spread
    over a full flush interval instead of re-stampeding together — while
    the *same* request always receives the same hint (testable, and a
    client retry loop stays reproducible)."""
    digest = hashlib.sha256(key.encode()).digest()
    frac = int.from_bytes(digest[:4], "big") / float(1 << 32)
    return base_s * (1.0 + frac)


class ServiceOverloaded(RuntimeError):
    """Admission control rejected the request: the lane's queue is full.

    Carries `retry_after_s` — roughly a flush interval (when queue space
    plausibly opens up) plus per-request deterministic jitter
    (`retry_after_jitter`). The HTTP front-end maps this to
    503 + Retry-After.
    """

    def __init__(self, lane: str, queued: int, retry_after_s: float):
        super().__init__(
            f"serve lane {lane!r} queue full ({queued} pending) — "
            f"retry in {retry_after_s:.3f}s")
        self.retry_after_s = retry_after_s


class ServiceClosed(RuntimeError):
    """The service is shut (or shutting) down; no new work is admitted."""


class RequestTimeout(TimeoutError):
    """A request sat queued past its deadline and was never simulated."""


@dataclass
class ServeConfig:
    """Dispatcher knobs (defaults match docs/SERVING.md)."""
    flush_interval_s: float = 0.05   # max queue age before a bucket flushes
    batch_size: int = 8              # bucket capacity = padded batch size
    max_queue: int = 64              # pending-request bound per lane
    pad_batches: bool = True         # pad flushes to batch_size (one shape)
    guard_retrace: bool = True       # no_retrace(0) once a shape compiled
    default_timeout_s: Optional[float] = None   # queue deadline if unset

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.flush_interval_s < 0:
            raise ValueError("flush_interval_s must be >= 0")


@dataclass(eq=False)        # identity semantics: each pending is unique
class _Pending:
    """One unique simulation job; duplicates attach extra futures."""
    request: SimRequest
    key: str                        # content_hash x fingerprint (cache key)
    bucket: Tuple[int, int]         # exact arena shape (flows, links)
    enqueue_t: float
    deadline: Optional[float]
    futures: List[Future] = field(default_factory=list)
    # trace spans (no-ops when tracing is off): the request's root span
    # and its in-queue child, ended when the batch picks the request up
    span: object = NULL_SPAN
    q_span: object = NULL_SPAN


class _Lane:
    """Per-backend dispatch state: bounded queue, buckets, one thread."""

    def __init__(self, name: str, backend: Backend, clock: Clock,
                 config: ServeConfig):
        self.name = name
        self.backend = backend
        self.config = config
        self.cond = threading.Condition()
        self.buckets: Dict[Tuple[int, int], List[_Pending]] = {}
        self.inflight: Dict[str, _Pending] = {}
        self.queued = 0
        self.metrics = ServiceMetrics(clock)
        self.compiled_shapes: set = set()
        self.thread: Optional[threading.Thread] = None
        # test observability: `waits` counts dispatcher passes that went
        # back to waiting; `idle` is True exactly while it blocks
        self.waits = 0
        self.idle = False


class SimService:
    """Concurrent simulation service over one or more backends.

    `backends` is a single `Backend` or a mapping name -> `Backend`; each
    backend gets its own lane (bounded queue + dispatcher thread), so one
    overloaded simulator never starves another. `config` is one
    `ServeConfig` for every lane or, an addition of the port, a mapping
    lane name -> `ServeConfig` (a lane it omits takes the defaults), so
    that lanes may batch at their own sizes. See the module docstring for
    semantics.
    """

    def __init__(self, backends: Union[Backend, Mapping[str, Backend]],
                 *, config: Union[None, ServeConfig,
                                  Mapping[str, ServeConfig]] = None,
                 cache_dir: Optional[str] = None,
                 cache: Optional[ResultCache] = None,
                 clock: Optional[Clock] = None):
        if isinstance(backends, Backend):
            backends = {backends.name: backends}
        if not backends:
            raise ValueError("SimService needs at least one backend")
        configs = config if isinstance(config, Mapping) else \
            {name: config for name in backends}
        unknown = set(configs) - set(backends)
        if unknown:
            raise KeyError(f"config for unknown lanes {sorted(unknown)}")
        self.config = config if isinstance(config, ServeConfig) \
            else ServeConfig()
        self._clock = clock or MonotonicClock()
        if cache is not None and cache_dir is not None:
            raise ValueError("pass cache= or cache_dir=, not both")
        self._cache = cache if cache is not None else (
            ResultCache(cache_dir) if cache_dir else None)
        self._closed = False
        self._drain = True
        self._exec_lock = threading.Lock()   # serializes guarded run_many
        self._tracer = get_tracer()          # no-op unless REPRO_TRACE_DIR
        self._trace0 = trace_total()
        self._lanes: Dict[str, _Lane] = {}
        for name, backend in backends.items():
            lane = _Lane(name, backend, self._clock,
                         configs.get(name) or ServeConfig())
            lane.thread = threading.Thread(
                target=self._dispatch_loop, args=(lane,),
                name=f"serve-dispatch-{name}", daemon=True)
            self._lanes[name] = lane
        for lane in self._lanes.values():
            lane.thread.start()

    # ------------------------------------------------------------ public API
    def submit(self, request: SimRequest, *, backend: Optional[str] = None,
               timeout: Optional[float] = None) -> Future:
        """Enqueue one request; returns a `concurrent.futures.Future`
        resolving to a `SimResult`.

        Cache hits resolve before this returns. Duplicate in-flight
        requests coalesce onto one pending simulation. Raises
        `ServiceClosed` after shutdown began and `ServiceOverloaded` when
        the lane's queue is full. `timeout` bounds queue time (seconds,
        by the service clock); `None` falls back to
        `config.default_timeout_s`.
        """
        lane = self._lane(backend)
        if self._closed:
            raise ServiceClosed(f"service is closed; {request.num_flows}-"
                                "flow request rejected")
        lane.metrics.count("submitted")
        key = result_key(request, lane.backend)
        # spans are NULL_SPAN singletons when tracing is off — the hot
        # path then does no id generation, timestamping, or I/O
        root = self._tracer.start(
            "serve.request",
            attrs={"lane": lane.name, "num_flows": request.num_flows})
        admit = self._tracer.start("serve.admit", parent=root)
        fut: Future = Future()
        try:
            use_cache = self._cache is not None and not request.record_events
            if use_cache:
                hit = self._cache.get(key)
                if hit is not None:
                    lane.metrics.count("cache_hits")
                    lane.metrics.count("completed")
                    fut.set_result(hit)
                    admit.end()
                    root.end(status="cache-hit")
                    return fut
            if timeout is None:
                timeout = lane.config.default_timeout_s
            now = self._clock.now()
            with lane.cond:
                if self._closed:
                    raise ServiceClosed("service is closed")
                pending = lane.inflight.get(key)
                if pending is not None:
                    pending.futures.append(fut)
                    lane.metrics.count("coalesced")
                    admit.end()
                    root.end(status="coalesced")
                    return fut
                if lane.queued >= lane.config.max_queue:
                    lane.metrics.count("rejected")
                    raise ServiceOverloaded(
                        lane.name, lane.queued,
                        retry_after_jitter(lane.config.flush_interval_s,
                                           key))
                admit.end()
                pending = _Pending(
                    request=request, key=key,
                    bucket=self._bucket_key(request),
                    enqueue_t=now,
                    deadline=None if timeout is None else now + timeout,
                    futures=[fut])
                pending.span = root
                pending.q_span = self._tracer.start("serve.queue",
                                                    parent=root)
                lane.inflight[key] = pending
                lane.buckets.setdefault(pending.bucket, []).append(pending)
                lane.queued += 1
                lane.cond.notify_all()
            return fut
        except BaseException as exc:
            admit.end()
            root.end(status=f"error:{type(exc).__name__}")
            raise

    def metrics(self, backend: Optional[str] = None) -> dict:
        """Metrics snapshot: one lane's block, or the aggregate with a
        per-lane breakdown under "lanes". "compiles" is the process-wide
        count of compiled programs since the service started."""
        compiles = trace_total() - self._trace0
        per_lane = {
            name: lane.metrics.snapshot(
                compiles=compiles, queue_depth=lane.queued,
                dispatcher_alive=(lane.thread is not None
                                  and lane.thread.is_alive()))
            for name, lane in self._lanes.items()}
        if backend is not None:
            return per_lane[self._lane(backend).name]
        agg = merge_snapshots(per_lane)
        agg["lanes"] = per_lane
        return agg

    def close(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop admission, then drain (default) or fail queued work.

        drain=True: every queued bucket flushes (deadline rules
        suspended) and every future resolves before the dispatchers
        exit. drain=False: queued futures fail with `ServiceClosed`.
        Idempotent; `timeout` bounds the per-thread join.
        """
        self._closed = True
        self._drain = drain
        for lane in self._lanes.values():
            with lane.cond:
                if not drain:
                    dropped = [p for ps in lane.buckets.values() for p in ps]
                    lane.buckets.clear()
                    lane.inflight.clear()
                    lane.queued = 0
                    for p in dropped:
                        self._fail(lane, p.futures,
                                   ServiceClosed("service closed before "
                                                 "this request was run"))
                        p.q_span.end(status="closed")
                        p.span.end(status="closed")
                lane.cond.notify_all()
        for lane in self._lanes.values():
            if lane.thread is not None and lane.thread.is_alive() \
                    and lane.thread is not threading.current_thread():
                lane.thread.join(timeout)

    @property
    def closed(self) -> bool:
        return self._closed

    def health(self) -> dict:
        """Liveness summary for `/healthz`.

        status is "ok", "degraded" (a lane's dispatcher thread died —
        that backend's queue will never drain, even though submits still
        succeed), or "closed". `ok` is True only for "ok": a degraded
        service must fail load-balancer health checks so traffic moves
        to a live replica instead of queueing into a dead lane.
        """
        dead = sorted(name for name, lane in self._lanes.items()
                      if lane.thread is not None
                      and not lane.thread.is_alive())
        status = "closed" if self._closed else \
            ("degraded" if dead else "ok")
        return {"ok": status == "ok", "status": status,
                "backends": sorted(self._lanes), "dead_lanes": dead}

    def __enter__(self) -> "SimService":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close(drain=exc_type is None)

    # -------------------------------------------------------------- plumbing
    def _lane(self, backend: Optional[str]) -> _Lane:
        if backend is None:
            if len(self._lanes) == 1:
                return next(iter(self._lanes.values()))
            raise ValueError(f"multiple backends served "
                             f"({sorted(self._lanes)}); pass backend=")
        try:
            return self._lanes[backend]
        except KeyError:
            raise KeyError(f"unknown backend {backend!r}; serving "
                           f"{sorted(self._lanes)}") from None

    @staticmethod
    def _bucket_key(request: SimRequest) -> Tuple[int, int]:
        """Exact arena shape: requests in one bucket pad identically, so
        every flush of the bucket reuses one compiled program."""
        return (request.num_flows, request.topo.num_links)

    @staticmethod
    def _fail(lane: _Lane, futures: List[Future], exc: Exception,
              counter: str = "failed"):
        for f in futures:
            try:
                f.set_exception(exc)
                lane.metrics.count(counter)
            except InvalidStateError:
                pass    # racing cancel() — the caller gave up first

    # ------------------------------------------------------------ dispatcher
    def _dispatch_loop(self, lane: _Lane):
        while True:
            with lane.cond:
                batch = None
                while batch is None:
                    self._expire_locked(lane)
                    batch = self._pick_batch_locked(lane)
                    if batch is not None:
                        break
                    if self._closed and lane.queued == 0:
                        return
                    lane.waits += 1
                    lane.idle = True
                    lane.cond.notify_all()      # wake test synchronizers
                    self._clock.wait(lane.cond,
                                     self._wait_timeout_locked(lane))
                    lane.idle = False
            self._run_batch(lane, batch)

    def _expire_locked(self, lane: _Lane):
        """Fail queued requests whose deadline passed (never simulated)."""
        now = self._clock.now()
        for bucket_key in list(lane.buckets):
            pendings = lane.buckets[bucket_key]
            expired = [p for p in pendings
                       if p.deadline is not None and now >= p.deadline]
            if not expired:
                continue
            lane.buckets[bucket_key] = [p for p in pendings
                                        if p not in expired]
            if not lane.buckets[bucket_key]:
                del lane.buckets[bucket_key]
            for p in expired:
                lane.inflight.pop(p.key, None)
                lane.queued -= 1
                self._fail(lane, p.futures, RequestTimeout(
                    f"request queued {now - p.enqueue_t:.3f}s, past its "
                    f"deadline, and was never simulated"),
                    counter="timed_out")
                p.q_span.end(status="timeout")
                p.span.end(status="timeout")

    def _pick_batch_locked(self, lane: _Lane) -> Optional[List[_Pending]]:
        """The oldest bucket that is full, past its flush deadline, or —
        during drain — simply non-empty; None if nothing is due."""
        now = self._clock.now()
        flush_all = self._closed and self._drain
        for bucket_key in list(lane.buckets):
            pendings = lane.buckets[bucket_key]
            due = (len(pendings) >= lane.config.batch_size or flush_all
                   or now >= pendings[0].enqueue_t
                   + lane.config.flush_interval_s)
            if not due:
                continue
            take = pendings[:lane.config.batch_size]
            rest = pendings[lane.config.batch_size:]
            if rest:
                lane.buckets[bucket_key] = rest
            else:
                del lane.buckets[bucket_key]
            lane.queued -= len(take)
            for p in take:
                lane.inflight.pop(p.key, None)
            return take
        return None

    def _wait_timeout_locked(self, lane: _Lane) -> Optional[float]:
        """Seconds until the next flush or request deadline (None = no
        queued work, sleep until notified)."""
        now = self._clock.now()
        deadlines = []
        for pendings in lane.buckets.values():
            deadlines.append(pendings[0].enqueue_t
                             + lane.config.flush_interval_s)
            deadlines.extend(p.deadline for p in pendings
                             if p.deadline is not None)
        if not deadlines:
            return None
        return max(0.0, min(deadlines) - now)

    def _run_batch(self, lane: _Lane, batch: List[_Pending]):
        t_flush = self._clock.now()
        tracing = self._tracer.enabled
        t_flush_wall = time.time() if tracing else 0.0
        live: List[Tuple[_Pending, List[Future]]] = []
        for p in batch:
            lane.metrics.observe_queue_delay(t_flush - p.enqueue_t)
            p.q_span.end()
            futs = [f for f in p.futures if f.set_running_or_notify_cancel()]
            if futs:
                live.append((p, futs))
            else:
                lane.metrics.count("cancelled")
                p.span.end(status="cancelled")
        if not live:
            return
        requests = [p.request for p, _ in live]
        n_pad = 0
        if lane.config.pad_batches and len(requests) < lane.config.batch_size:
            n_pad = lane.config.batch_size - len(requests)
            requests = requests + [requests[0]] * n_pad
        shape = (live[0][0].bucket, len(requests))
        if tracing:
            t_ready = time.time()
            for p, _ in live:
                self._tracer.emit_span(
                    "serve.flush", p.span, t_flush_wall, t_ready,
                    attrs={"batch": len(live), "padded": n_pad})
        windows: List[Tuple[str, float, float]] = []
        try:
            results = self._execute(lane, requests, shape,
                                    windows)[:len(live)]
        except Exception:
            # the batch as a whole failed — isolate per request so one
            # poisoned scenario can't take its flush-mates down with it
            self._isolate(lane, live)
            return
        lane.metrics.count("batches")
        lane.metrics.count("batched_requests", len(live))
        lane.metrics.count("padded_requests", n_pad)
        if tracing:
            for p, _ in live:
                for name, w0, w1 in windows:
                    self._tracer.emit_span(name, p.span, w0, w1)
        for (p, futs), res in zip(live, results):
            self._deliver(lane, p, futs, res)

    def _timed_run(self, lane: _Lane, requests: List[SimRequest],
                   windows: List[Tuple[str, float, float]],
                   name: str) -> List[SimResult]:
        t0 = time.time()
        results = lane.backend.run_many(requests)
        windows.append((name, t0, time.time()))
        return results

    def _execute(self, lane: _Lane, requests: List[SimRequest],
                 shape, windows=None) -> List[SimResult]:
        """run_many under the compile guard: the first flush of a shape
        may compile; every later one must not (`no_retrace(allowed=0)`).
        Guarded flushes serialize on one lock because the compile
        counters are process-global — two lanes compiling concurrently
        would read each other's traces as budget violations.

        `windows` (tracing only) collects named wall-clock windows: a
        first-flush-of-shape records `serve.compile`, then — so the
        trace separates compile wall from steady wall — re-runs the
        (pure, now-compiled) batch once as the `serve.run` window.
        Warm flushes record a single `serve.run` window."""
        tracing = windows is not None and self._tracer.enabled
        if not lane.config.guard_retrace:
            if tracing:
                return self._timed_run(lane, requests, windows, "serve.run")
            return lane.backend.run_many(requests)
        with self._exec_lock:
            if shape in lane.compiled_shapes:
                with no_retrace(allowed=0,
                                label=f"serve lane '{lane.name}' "
                                      f"shape {shape}"):
                    if tracing:
                        return self._timed_run(lane, requests, windows,
                                               "serve.run")
                    return lane.backend.run_many(requests)
            if tracing:
                results = self._timed_run(lane, requests, windows,
                                          "serve.compile")
                lane.compiled_shapes.add(shape)
                results = self._timed_run(lane, requests, windows,
                                          "serve.run")
                return results
            results = lane.backend.run_many(requests)
            lane.compiled_shapes.add(shape)
            return results

    def _isolate(self, lane: _Lane, live):
        """Per-request fallback after a batch-level failure: each request
        re-runs alone, so exactly the poisoned ones fail (with their own
        error) and the healthy ones still resolve."""
        for p, futs in live:
            lane.metrics.count("isolated_retries")
            try:
                res = lane.backend.run(p.request)
            except Exception as exc:
                self._fail(lane, futs, exc)
                p.span.end(status=f"error:{type(exc).__name__}")
                continue
            self._deliver(lane, p, futs, res)

    def _deliver(self, lane: _Lane, p: _Pending, futs: List[Future],
                 res: SimResult):
        """Health-check, cache, and resolve one pending's futures."""
        try:
            check_result_finite(f"serve:{lane.name}", res)
        except NonFiniteError as exc:
            self._fail(lane, futs, exc)
            p.span.end(status="nonfinite")
            return
        if self._cache is not None and not p.request.record_events:
            self._cache.put(p.key, res)
        for f in futs:
            try:
                f.set_result(res)
                lane.metrics.count("completed")
            except InvalidStateError:
                lane.metrics.count("cancelled")
        p.span.end()
