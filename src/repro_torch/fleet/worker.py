"""Fleet worker process (`repro_torch.fleet.worker`).

The port's copy of `repro.fleet.worker`.

`worker_entry` is the spawn target: it scans the task list, claims
unowned tasks through `LeaseDir` (O_CREAT|O_EXCL — the filesystem picks
exactly one winner), heartbeats the lease from a daemon thread while the
chunk runs, writes results through the job's blobstore, *verifies* them
back (an unreadable result is an error, not a success), and marks the
task done. Any exception is recorded to the err marker with its
`classify_error` verdict — the supervisor decides retry vs poison; the
worker never retries its own failures.

A worker exits 0 once every task is terminal (done or poisoned). It
does not exit just because nothing is claimable right now: a task
parked in backoff (err marker present) will need hands once the
supervisor clears the marker.

Chaos hooks (`ChaosMonkey`) sit at the claim/run/put/done seams; with
no fault plan they are inert no-ops. This module imports no simulator:
the job's `run` pulls in what it needs. A worker runs one task at a
time on one thread, so on the card its kernels never overlap each other
(the GNN's grid barrier keeps one count per process and device).
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

from ..obs.trace import get_tracer, new_id, task_trace_id
from ..runtime.resilience import classify_error
from .chaos import ChaosMonkey, FaultPlan
from .coord import Coordinator
from .jobs import FleetJob


def _heartbeat_loop(leases, task_id: str, interval_s: float,
                    stop: threading.Event, monkey: ChaosMonkey):
    while not stop.wait(interval_s):
        if monkey.stalled:      # chaos stall: go silent, let the lease rot
            return
        leases.heartbeat(task_id)


def worker_entry(worker_index: int, coord_root: str, job: FleetJob,
                 tasks: List[Tuple[str, dict]],
                 plan: Optional[FaultPlan] = None,
                 heartbeat_s: float = 0.5, poll_s: float = 0.1) -> None:
    coord = Coordinator(coord_root)
    owner = f"w{worker_index}"
    # tracing rides in on env (REPRO_TRACE_DIR / REPRO_TRACE_PARENT,
    # inherited through spawn); with neither set this is all no-ops
    tracer = get_tracer()
    tracer.proc = f"fleet-{owner}"
    wspan = tracer.span("fleet.worker", attrs={"worker": worker_index})
    monkey = ChaosMonkey(plan, worker_index, coord.chaos_dir,
                         [tid for tid, _ in tasks])
    # stagger scan order per worker so the pool doesn't stampede the
    # same first lease (O_EXCL arbitrates correctly either way)
    if tasks:
        k = worker_index % len(tasks)
        tasks = tasks[k:] + tasks[:k]
    claims = 0

    while True:
        all_terminal = True
        for task_id, payload in tasks:
            if coord.is_done(task_id) or coord.is_poisoned(task_id):
                continue
            all_terminal = False
            # err marker = parked for the supervisor (backoff or poison
            # decision pending); held lease = someone else is on it
            if coord.has_error(task_id) or coord.leases.held(task_id):
                continue
            # trace/span ids travel in the lease body: the task's trace
            # id is deterministic (sha256 of the task id), so every
            # retry attempt lands in the same trace, and the lease names
            # the root span of the attempt that holds the chunk
            meta = None
            root_sid = ""
            if tracer.enabled:
                root_sid = new_id()
                meta = {"trace_id": task_trace_id(task_id),
                        "span_id": root_sid}
            t_claim0 = time.time()
            if not coord.leases.claim(task_id, owner, meta=meta):
                continue
            claims += 1
            root = tracer.span(
                "fleet.task", trace_id=task_trace_id(task_id),
                span_id=root_sid or None,
                attrs={"task": task_id[:16], "owner": owner,
                       "attempt": claims})
            if tracer.enabled:
                root.t_start = t_claim0     # the claim belongs to the task
                tracer.emit_span("fleet.claim", root, t_claim0, time.time())
            stop = threading.Event()
            hb = threading.Thread(
                target=_heartbeat_loop,
                args=(coord.leases, task_id, heartbeat_s, stop, monkey),
                daemon=True)
            hb.start()
            t0 = time.perf_counter()
            try:
                monkey.on_claim(task_id, claims)
                monkey.on_run(task_id)
                job.run(payload)    # emits fleet.build / fleet.cache-write
                monkey.post_put(task_id, job.result_paths(payload))
                with tracer.span("fleet.verify"):
                    missing = job.verify(payload)
                if missing:
                    # quarantined/unreadable right after writing — treat
                    # as transient I/O, recompute on retry
                    raise IOError(
                        "results unreadable after write: "
                        + ", ".join(m[:12] for m in missing))
                monkey.pre_done(task_id, claims)
                try:
                    extra = job.done_extra(payload)
                except Exception:       # telemetry only — a finished task
                    extra = None        # never fails on its bookkeeping
                with tracer.span("fleet.done"):
                    coord.mark_done(task_id, owner,
                                    time.perf_counter() - t0, claims,
                                    extra=extra)
                root.end(status="done")
            except Exception as exc:
                coord.mark_error(task_id, owner, exc, classify_error(exc))
                root.end(status=f"error:{type(exc).__name__}")
            finally:
                stop.set()
                coord.leases.release(task_id)
        if all_terminal:
            wspan.end()
            return
        time.sleep(poll_s)
