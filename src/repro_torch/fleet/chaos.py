"""Deterministic fault injection for fleet runs (`repro_torch.fleet.chaos`).

The port's copy of `repro.fleet.chaos`: the same DSL, the same fault
ids and the same one-shot marker files.

A `FaultPlan` is seeded, declarative data: *which* fault fires *where*
is decided before the run, not by wall-clock races, so a chaos test can
assert exact convergence ("this plan kills two workers and corrupts one
blob, and the cache still ends bitwise-identical to a clean run").

Plan mini-DSL (the `--chaos` CLI flag and `parse_plan`):

    kill:worker=0,after=2        worker 0 os._exit()s on its 2nd claim
    kill:worker=1,after=1,where=post   ...after writing results, before
                                       the done marker (tests resume)
    stall:worker=0,after=1       heartbeat stops + worker hangs: the
                                 supervisor must reap the stale lease
    corrupt:task=5               flip one byte of task 5's first result
                                 blob right after it is written (the
                                 blobstore integrity check must heal it)
    raise:task=3,exc=oserror,times=2   the task's run raises a transient
                                       OSError on its first 2 attempts
    raise:task=2,exc=valueerror  deterministic failure -> poison path

Faults are one-shot across the whole fleet *including restarts*: firing
is recorded via O_EXCL marker files in the coordination directory, so a
respawned worker never re-fires a kill and a retried chunk sees
`times=N` raise-faults exactly N times. `task=<i>` indexes the sorted
task-id list (stable across launches — task ids are content hashes);
`worker=<i>` is the supervisor-assigned worker index (initial pool is
0..workers-1, respawns continue counting).

Injection is cooperative: `ChaosMonkey` hook points sit at the worker
loop's claim/run/post-put/pre-done seams (`repro_torch.fleet.worker`), which
is exactly where real failures land — mid-claim crashes, hung
backends, torn writes — without patching the production code paths.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

_KINDS = ("kill", "stall", "corrupt", "raise")
_EXCS = {"oserror": OSError, "ioerror": IOError,
         "timeout": TimeoutError, "valueerror": ValueError,
         "runtimeerror": RuntimeError}


@dataclass(frozen=True)
class Fault:
    """One declarative fault (see the module docstring for the DSL)."""
    kind: str                       # kill | stall | corrupt | raise
    worker: Optional[int] = None    # kill/stall: target worker index
    after: int = 1                  # kill/stall: the worker's Nth claim
    task: Optional[int] = None      # corrupt/raise: sorted-task index
    exc: str = "oserror"            # raise: key into _EXCS
    times: int = 1                  # raise: attempts that fail
    where: str = "pre"              # kill: pre (before run) | post

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(want one of {_KINDS})")
        if self.kind in ("kill", "stall") and self.worker is None:
            raise ValueError(f"{self.kind} fault needs worker=<index>")
        if self.kind in ("corrupt", "raise") and self.task is None:
            raise ValueError(f"{self.kind} fault needs task=<index>")
        if self.kind == "raise" and self.exc not in _EXCS:
            raise ValueError(f"unknown exc {self.exc!r} "
                             f"(want one of {sorted(_EXCS)})")
        if self.where not in ("pre", "post"):
            raise ValueError(f"where must be pre|post, got {self.where!r}")

    @property
    def fault_id(self) -> str:
        """Stable id used for the one-shot fired markers."""
        return (f"{self.kind}-w{self.worker}-a{self.after}-t{self.task}"
                f"-{self.exc}-{self.where}")


@dataclass(frozen=True)
class FaultPlan:
    """A seeded set of faults; `spec` keeps the original DSL text for
    logs and the metrics JSON."""
    faults: Tuple[Fault, ...] = ()
    seed: int = 0
    spec: str = ""

    def __bool__(self) -> bool:
        return bool(self.faults)


def parse_plan(spec: str, seed: int = 0) -> FaultPlan:
    """Parse the `--chaos` mini-DSL into a `FaultPlan`.

    `spec` is `;`-separated faults, each `kind[:key=val,...]`, e.g.
    `"kill:worker=0,after=2;corrupt:task=5"`. Empty spec -> empty plan.
    """
    faults = []
    for part in filter(None, (p.strip() for p in spec.split(";"))):
        kind, _, rest = part.partition(":")
        kw: Dict[str, object] = {}
        for item in filter(None, (i.strip() for i in rest.split(","))):
            key, _, val = item.partition("=")
            if not val:
                raise ValueError(f"bad fault item {item!r} in {part!r} "
                                 "(want key=value)")
            kw[key] = (int(val) if val.lstrip("-").isdigit() else val)
        faults.append(Fault(kind=kind.strip(), **kw))
    return FaultPlan(faults=tuple(faults), seed=seed, spec=spec)


class ChaosMonkey:
    """Worker-side fault executor: consulted at the claim/run/put/done
    seams of `repro_torch.fleet.worker`. A monkey with an empty plan is inert
    (every hook is a cheap no-op)."""

    #: seconds a stalled worker hangs — far beyond any sane lease
    #: timeout, so the supervisor must reap it (SIGKILL ends the sleep)
    stall_s: float = 120.0

    def __init__(self, plan: Optional[FaultPlan], worker_index: int,
                 chaos_dir: str, task_ids: Sequence[str]):
        self.plan = plan or FaultPlan()
        self.worker_index = worker_index
        self.chaos_dir = chaos_dir
        # task=<i> resolves against the *sorted* id list: stable across
        # launches regardless of submission order
        self._by_task: Dict[str, List[Fault]] = {}
        ordered = sorted(task_ids)
        for f in self.plan.faults:
            if f.task is not None and f.task < len(ordered):
                self._by_task.setdefault(ordered[f.task], []).append(f)
        self.stalled = False

    # ------------------------------------------------------------ firing
    def _fire(self, fault: Fault, attempt_slots: int = 1) -> bool:
        """Claim one firing of `fault` (O_EXCL marker per slot); False
        once all `attempt_slots` firings have been claimed fleet-wide."""
        os.makedirs(self.chaos_dir, exist_ok=True)
        for n in range(attempt_slots):
            path = os.path.join(self.chaos_dir, f"{fault.fault_id}.{n}")
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                continue
            with os.fdopen(fd, "w") as f:
                f.write(f"pid={os.getpid()} t={time.time()}")
            return True
        return False

    # ------------------------------------------------------- hook points
    def on_claim(self, task_id: str, nth_claim: int):
        """After winning a lease, before running: kill(pre) and stall."""
        for f in self.plan.faults:
            if f.worker != self.worker_index or f.after != nth_claim:
                continue
            if f.kind == "kill" and f.where == "pre" and self._fire(f):
                os._exit(13)    # SIGKILL-like: no cleanup, lease left held
            if f.kind == "stall" and self._fire(f):
                self.stalled = True     # heartbeat thread stops touching

    def on_run(self, task_id: str):
        """Entering the chunk's compute: stalls hang, raise-faults raise."""
        if self.stalled:
            time.sleep(self.stall_s)    # reaped by SIGKILL long before this
        for f in self._by_task.get(task_id, ()):
            if f.kind == "raise" and self._fire(f, attempt_slots=f.times):
                raise _EXCS[f.exc](
                    f"chaos-injected {f.exc} in task {task_id[:12]}")

    def post_put(self, task_id: str, paths: Sequence[str]):
        """Results just written, not yet verified: corrupt faults flip a
        seeded byte in one result blob — the integrity envelope must
        catch it and the retry path must heal it."""
        for f in self._by_task.get(task_id, ()):
            if f.kind != "corrupt" or not paths or not self._fire(f):
                continue
            path = paths[(self.plan.seed + (f.task or 0)) % len(paths)]
            try:
                with open(path, "r+b") as fh:
                    data = bytearray(fh.read())
                    if not data:
                        continue
                    pos = (self.plan.seed * 2654435761 + len(data) // 2) \
                        % len(data)
                    data[pos] ^= 0xFF
                    fh.seek(0)
                    fh.write(data)
            except OSError:
                pass

    def pre_done(self, task_id: str, nth_claim: int):
        """Results verified, done marker not yet written: kill(post)
        proves a relaunch resumes from completed *results*, not markers."""
        for f in self.plan.faults:
            if (f.kind == "kill" and f.where == "post"
                    and f.worker == self.worker_index
                    and f.after == nth_claim and self._fire(f)):
                os._exit(13)
