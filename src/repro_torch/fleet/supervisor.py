"""Fleet supervisor (`repro_torch.fleet.supervisor`).

The port's copy of `repro.fleet.supervisor`: the same policy, counters
and coordination files.

`run_fleet(tasks, job, config)` drives a pool of spawned worker
processes to a terminal state where **every task is accounted for**:
done (results verified on disk) or poisoned (quarantined with a
traceback manifest). The supervisor owns every policy decision — workers
only compute and report:

- **Resume** — on startup, leases whose owner pid is gone are broken and
  done markers are re-verified against the blobstore (a marker whose
  results went missing or corrupt is retracted and the chunk requeued).
  Tasks completed by a previous launch count as `already_done` and are
  never recomputed.
- **Retry vs poison** — a worker's err marker carries the
  `classify_error` verdict. Retryable failures requeue with
  `Backoff.delay(attempt, task_id)` — capped exponential, deterministic
  per-task jitter — up to `max_attempts`; deterministic failures (or
  retryable ones that exhaust attempts) move to `poison/` and stop
  consuming workers.
- **Reaping** — a lease whose heartbeat goes stale (`lease_timeout_s`)
  marks a dead or wedged owner: the supervisor SIGKILLs the pid (only
  its own children), breaks the lease, and requeues through the same
  retry path. Workers that exit nonzero holding a lease get the same
  treatment; the pool is topped back up to `workers` while work remains.
- **Stragglers** — completed-chunk wall times feed a `StepDeadline`
  (median + k*MAD); running chunks past the deadline are counted as
  stragglers, and past `straggler_kill_factor x` deadline (or the hard
  `chunk_timeout_s`) their worker is reaped and the chunk requeued.
- **Verification** — after the pool drains, every done task is
  re-verified through the integrity-checked blobstore; failures retract
  the marker and re-enter the loop (bounded by `verify_rounds`).

- **Kernels before workers** — a job on the card (`job.device ==
  "cuda"`) has the kernels built (`kernels.build.build_all`) once here,
  before any spawn: the workers then only load the built libraries, and
  a first task never pays the `nvcc` build inside its deadline.

Correctness never rests on the supervisor's bookkeeping: results are
content-addressed atomic blobs, so the worst a wrong decision (broken
lease, double spawn) can cause is duplicate compute writing identical
bytes. Workers start by `spawn`, never `fork`: a process with a live
CUDA context cannot fork.
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..obs.trace import TRACE_PARENT_ENV, configure as obs_configure, \
    get_tracer
from ..runtime.resilience import Backoff, StepDeadline
from .chaos import FaultPlan
from .coord import Coordinator
from .jobs import FleetJob, Task
from .metrics import FleetMetrics

logger = logging.getLogger("repro_torch.fleet")


@dataclass(frozen=True)
class FleetConfig:
    """Knobs for one fleet run. Defaults suit real sweeps; tests shrink
    every timeout by ~10x."""
    workers: int = 2
    coord_dir: Optional[str] = None   # None: dispatcher derives one from
    #                                   its store root + the task-set digest
    heartbeat_s: float = 0.5          # worker lease-touch interval
    lease_timeout_s: float = 5.0      # heartbeat silence -> reap owner
    poll_s: float = 0.1               # supervisor/worker scan interval
    max_attempts: int = 3             # per-task tries before poison
    backoff: Backoff = field(default_factory=Backoff)
    chaos: Optional[FaultPlan] = None
    chunk_timeout_s: Optional[float] = None   # hard per-chunk wall cap
    straggler_kill_factor: float = 4.0        # x deadline -> reap
    deadline_k: float = 6.0                   # StepDeadline MAD multiplier
    verify_rounds: int = 2            # post-drain verify/requeue passes
    trace_dir: Optional[str] = None   # obs span JSONL dir; None
    #                                   falls back to $REPRO_TRACE_DIR

    def with_coord_dir(self, coord_dir: str) -> "FleetConfig":
        return dataclasses.replace(self, coord_dir=coord_dir)


def task_set_digest(tasks: List[Task]) -> str:
    """Stable id of a work set — the default coord-dir name, so a
    relaunch of the same work lands on the same markers and leases."""
    ids = sorted(tid for tid, _ in tasks)
    return hashlib.sha256("|".join(ids).encode()).hexdigest()[:16]


def default_coord_dir(base_root: str, tasks: List[Task]) -> str:
    return os.path.join(base_root, "fleet", task_set_digest(tasks))


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except (OSError, TypeError):
        return False


def run_fleet(tasks: List[Task], job: FleetJob, config: FleetConfig,
              log=None) -> FleetMetrics:
    """Drive `tasks` through `job` under `config` until every task is
    done or poisoned; returns the run's `FleetMetrics` (also written to
    `<coord_dir>/metrics.json`)."""
    if config.coord_dir is None:
        raise ValueError("FleetConfig.coord_dir is unset — dispatchers "
                         "must derive one (see default_coord_dir)")

    def say(msg: str):
        logger.info(msg)
        if log:
            log(f"[fleet] {msg}")

    import multiprocessing as mp
    ctx = mp.get_context("spawn")   # never fork a live CUDA context

    coord = Coordinator(config.coord_dir)
    payloads: Dict[str, dict] = dict(tasks)
    task_ids = [tid for tid, _ in tasks]
    metrics = FleetMetrics(
        total=len(tasks),
        chaos=config.chaos.spec if config.chaos else "")
    deadline = StepDeadline(k=config.deadline_k,
                            floor_s=config.lease_timeout_s)
    # tracing: configure() also exports REPRO_TRACE_DIR, and the run
    # span's ids go out via REPRO_TRACE_PARENT, so spawned workers both
    # trace into the same directory and parent their lifetime spans here
    tracer = (obs_configure(config.trace_dir, proc="fleet-supervisor")
              if config.trace_dir else get_tracer())
    run_span = tracer.span(
        "fleet.run", attrs={"tasks": len(tasks), "workers": config.workers,
                            "chaos": config.chaos.spec if config.chaos
                            else ""})
    trace_parent_set = False
    if tracer.enabled:
        os.environ[TRACE_PARENT_ENV] = \
            f"{run_span.trace_id}:{run_span.span_id}"
        trace_parent_set = True
    t0 = time.perf_counter()

    # ------------------------------------------------- startup recovery
    for tid in coord.leases.active():
        info = coord.leases.owner(tid) or {}
        if not _pid_alive(info.get("pid")):
            coord.leases.release(tid)
            metrics.lease_breaks += 1
            say(f"broke stale lease {tid[:12]} "
                f"(owner {info.get('owner', '?')} gone)")
    pending: Set[str] = set()
    for tid in task_ids:
        if coord.is_poisoned(tid):
            continue
        if coord.is_done(tid):
            missing = job.verify(payloads[tid])
            if not missing:
                metrics.already_done += 1
                continue
            coord.clear_done(tid)
            metrics.verify_requeues += 1
            say(f"done marker {tid[:12]} had unreadable results — requeued")
        coord.clear_error(tid)   # stale park from a dead launch
        pending.add(tid)
    if metrics.already_done:
        say(f"resuming: {metrics.already_done}/{len(tasks)} task(s) "
            "already complete")
    if pending and getattr(job, "device", "cpu") == "cuda":
        from ..kernels.build import build_all
        say(f"kernels built in {build_all():.1f}s before spawning")

    # --------------------------------------------------- worker pool
    procs: Dict[int, object] = {}       # worker index -> Process
    next_index = 0

    def spawn(n: int = 1):
        """Start `n` workers side by side. `start()` returns once the
        child has read its pickled arguments from a pipe, and the child
        reads the job only after importing this package, which imports
        torch: a job larger than the pipe (m4's weights) would make each
        start wait for the previous child's torch import."""
        nonlocal next_index
        new = []
        for _ in range(n):
            idx = next_index
            new.append(ctx.Process(
                target=_entry, name=f"fleet-w{idx}",
                args=(idx, coord.root, job, tasks, config.chaos,
                      config.heartbeat_s, config.poll_s),
                daemon=True))
            procs[idx] = new[-1]
            next_index += 1
            metrics.workers_spawned += 1
            if metrics.workers_spawned > config.workers:
                metrics.worker_restarts += 1
        errors = []

        def start(p):
            try:
                p.start()
            except BaseException as exc:   # re-raised below, in this thread
                errors.append(exc)
        starters = [threading.Thread(target=start, args=(p,)) for p in new]
        for t in starters:
            t.start()
        for t in starters:
            t.join()
        if errors:
            for idx, p in list(procs.items()):
                if p.pid is None:       # never started: nothing to join
                    del procs[idx]
            raise errors[0]

    def reap(tid: str, owner: str, pid, why: str):
        """Break a lease and requeue its task through the retry path."""
        if pid in {p.pid for p in procs.values()} and _pid_alive(pid):
            os.kill(pid, signal.SIGKILL)
            metrics.kills += 1
        coord.leases.release(tid)
        metrics.lease_breaks += 1
        coord.synthetic_error(tid, owner, why)
        say(f"reaped {tid[:12]} ({why})")

    attempts: Dict[str, int] = {}
    requeue_at: Dict[str, float] = {}
    flagged: Set[Tuple[str, int]] = set()   # straggler (task, attempt)

    try:
        while pending:
            if not procs and pending:
                spawn(min(config.workers, max(len(pending), 1)))
            now = time.monotonic()

            # ---- completions / poisons / errors
            for tid in sorted(pending):
                if coord.is_done(tid):
                    rec = coord.done_record(tid) or {}
                    wall = rec.get("wall_s")
                    if wall is not None:
                        wall = float(wall)
                        deadline.observe(wall)
                        metrics.chunk_wall.observe(wall)
                    pending.discard(tid)
                    metrics.computed += 1
                    requeue_at.pop(tid, None)
                    continue
                if coord.is_poisoned(tid):
                    pending.discard(tid)
                    continue
                err = coord.error_record(tid)
                if err is not None and tid not in requeue_at:
                    n = attempts[tid] = attempts.get(tid, 0) + 1
                    if err.get("retryable") and n < config.max_attempts:
                        delay = config.backoff.delay(n, token=tid)
                        requeue_at[tid] = now + delay
                        metrics.retried += 1
                        say(f"retry {tid[:12]} attempt {n + 1} in "
                            f"{delay:.2f}s ({err.get('exc_type')}: "
                            f"{err.get('exc', '')[:80]})")
                    else:
                        why = ("deterministic failure"
                               if not err.get("retryable")
                               else f"exhausted {n} attempts")
                        coord.mark_poison(tid, {**err, "attempts": n,
                                                "why": why})
                        coord.clear_error(tid)
                        metrics.poisoned += 1
                        pending.discard(tid)
                        say(f"poisoned {tid[:12]} ({why}: "
                            f"{err.get('exc_type')})")
                elif tid in requeue_at and now >= requeue_at[tid]:
                    coord.clear_error(tid)      # open for claiming again
                    del requeue_at[tid]

            # ---- lease health: stale heartbeats + stragglers
            for tid in coord.leases.active():
                if tid not in pending:
                    coord.leases.release(tid)   # lease outlived its task
                    continue
                age = coord.leases.age(tid)
                if age is None:
                    continue
                info = coord.leases.owner(tid) or {}
                owner = info.get("owner", "?")
                if age > config.lease_timeout_s:
                    reap(tid, owner, info.get("pid"),
                         f"no heartbeat for {age:.1f}s")
                    continue
                runtime = time.time() - info.get("t_claim", time.time())
                dl = deadline.deadline
                n = attempts.get(tid, 0)
                if runtime > dl and (tid, n) not in flagged:
                    flagged.add((tid, n))
                    metrics.stragglers += 1
                    say(f"straggler {tid[:12]}: {runtime:.1f}s "
                        f"(deadline {dl:.1f}s)")
                hard = config.chunk_timeout_s
                if (runtime > dl * config.straggler_kill_factor
                        or (hard is not None and runtime > hard)):
                    reap(tid, owner, info.get("pid"),
                         f"chunk overdue after {runtime:.1f}s")

            # ---- worker health: collect exits, requeue orphaned leases
            for idx, p in list(procs.items()):
                if p.exitcode is None:
                    continue
                del procs[idx]
                if p.exitcode != 0:
                    say(f"worker w{idx} exited {p.exitcode}")
                    for tid in coord.leases.active():
                        info = coord.leases.owner(tid) or {}
                        if (info.get("owner") == f"w{idx}"
                                and tid in pending):
                            coord.leases.release(tid)
                            metrics.lease_breaks += 1
                            coord.synthetic_error(
                                tid, f"w{idx}",
                                f"worker exited {p.exitcode} mid-chunk")

            # ---- keep the pool full while work remains
            short = min(config.workers, max(len(pending), 1)) - len(procs)
            if pending and short > 0:
                spawn(short)

            if pending:
                time.sleep(config.poll_s)

            # ---- drained: verify completions, requeue what fails
            # (bounded: at most verify_rounds retractions per task)
            if not pending:
                bad = [tid for tid in task_ids
                       if coord.is_done(tid) and job.verify(payloads[tid])]
                if bad and metrics.verify_requeues < \
                        config.verify_rounds * len(tasks):
                    for tid in bad:
                        coord.clear_done(tid)
                        metrics.verify_requeues += 1
                        pending.add(tid)
                    say(f"verify pass retracted {len(bad)} done "
                        "marker(s) with unreadable results")
    finally:
        # workers exit 0 on their own once everything is terminal;
        # anything still running after a grace period gets killed
        for p in procs.values():
            p.join(timeout=2 * config.poll_s + config.heartbeat_s)
        for p in procs.values():
            if p.exitcode is None:
                p.kill()
                p.join(timeout=5)

    metrics.done = sum(coord.is_done(tid) for tid in task_ids)
    metrics.poisoned = sum(coord.is_poisoned(tid) for tid in task_ids)
    metrics.poison = [rec for rec in coord.poison_manifest()
                      if rec.get("task") in payloads]
    metrics.stragglers = max(metrics.stragglers, deadline.stragglers)
    metrics.wall_s = time.perf_counter() - t0
    coord.write_metrics(metrics.as_dict())
    coord.write_obs(metrics.obs_snapshot())
    run_span.end(done=metrics.done, poisoned=metrics.poisoned,
                 computed=metrics.computed)
    if trace_parent_set:
        os.environ.pop(TRACE_PARENT_ENV, None)
    say(f"fleet done: {metrics.done}/{metrics.total} complete "
        f"({metrics.already_done} resumed, {metrics.computed} computed), "
        f"{metrics.poisoned} poisoned, {metrics.retried} retried, "
        f"{metrics.kills} kill(s), {metrics.wall_s:.1f}s")
    return metrics


def _entry(*args):
    """Spawn trampoline: import inside the child so the worker module
    resolves in the fresh interpreter."""
    from .worker import worker_entry
    worker_entry(*args)
