"""Fault-tolerance policies behind `repro_torch.fleet`.

The port's copy of `repro.runtime.resilience`, the policy layer the fleet
supervisor (`repro_torch.fleet.supervisor`) enforces on every run:

1. **Straggler detection**: `StepDeadline` keeps a robust
   (median + k*MAD) per-chunk deadline over completed chunk wall times;
   the supervisor flags running chunks past it as stragglers and reaps
   workers that blow well past it.
2. **Retry policy**: `Backoff` computes capped exponential backoff with
   *deterministic* jitter (hashed from seed x task x attempt, no global
   RNG): requeued chunks never re-stampede in lockstep, yet a replayed
   fleet run schedules identically.
3. **Error taxonomy**: `classify_error` splits failures into retryable
   (crashes, timeouts, transient I/O: the chunk deserves another worker)
   and poison (deterministic failures: re-running reproduces them, so
   the chunk is quarantined to the poison manifest).
4. **Elastic scaling**: `remesh` re-shards a checkpointed tree onto a new
   `DeviceMesh` by replaying sharding rules against it (grow/shrink of
   `data` ranks never touches replicated weights). `StepDeadline` and
   `Timed` also serve the LM launch harness (`launch/train.py`).
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass
class StepDeadline:
    """Robust straggler detector: deadline = median + k * MAD (>= floor)."""
    k: float = 6.0
    floor_s: float = 0.05
    history: List[float] = field(default_factory=list)
    stragglers: int = 0

    def observe(self, dt: float) -> bool:
        """Record a step time; returns True if this step straggled."""
        hist = self.history
        straggled = False
        if len(hist) >= 8:
            med = float(np.median(hist))
            mad = float(np.median(np.abs(np.asarray(hist) - med))) + 1e-9
            if dt > max(med + self.k * mad, self.floor_s):
                straggled = True
                self.stragglers += 1
        hist.append(dt)
        if len(hist) > 256:
            del hist[0]
        return straggled

    @property
    def deadline(self) -> float:
        if len(self.history) < 8:
            return float("inf")
        med = float(np.median(self.history))
        mad = float(np.median(np.abs(np.asarray(self.history) - med))) + 1e-9
        return max(med + self.k * mad, self.floor_s)


@dataclass(frozen=True)
class Backoff:
    """Capped exponential backoff with deterministic, desynchronizing
    jitter.

    delay(attempt) grows base * factor^(attempt-1) up to cap, then a
    jitter fraction hashed from (seed, token, attempt) is *subtracted*:
    two chunks requeued at the same instant get different delays, while
    the same (seed, token, attempt) always gives the same delay, which
    the chaos harness relies on.
    """
    base_s: float = 0.5
    factor: float = 2.0
    cap_s: float = 30.0
    jitter: float = 0.5       # fraction of the delay that jitter can shave
    seed: int = 0

    def delay(self, attempt: int, token: str = "") -> float:
        """Seconds to wait before retry number `attempt` (1-based)."""
        raw = min(self.base_s * self.factor ** max(attempt - 1, 0),
                  self.cap_s)
        h = hashlib.sha256(
            f"{self.seed}|{token}|{attempt}".encode()).digest()
        frac = int.from_bytes(h[:4], "big") / float(1 << 32)
        return raw * (1.0 - self.jitter * frac)


# Exception types whose failures are worth retrying on another worker:
# process crashes and timeouts are detected out-of-band (no exception
# object survives a SIGKILL), so this covers in-process transients.
RETRYABLE_EXC_TYPES = (OSError, TimeoutError, ConnectionError,
                       InterruptedError, MemoryError)


def classify_error(exc: BaseException) -> bool:
    """True if `exc` is retryable (transient), False if poison.

    Retryable: OSError and friends, plus anything whose `retryable`
    attribute says so. Poison: deterministic failures (ValueError,
    TypeError, shape errors, NotImplementedError, ...), which re-running
    reproduces. `torch.cuda.OutOfMemoryError` is a RuntimeError, not a
    MemoryError, so it is poison, as XLA's runtime errors are under the
    JAX package's rule: a chunk that does not fit on the card does not
    fit on the next try either.
    """
    if isinstance(exc, RETRYABLE_EXC_TYPES):
        return True
    return bool(getattr(exc, "retryable", False))


class Timed:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.dt = time.perf_counter() - self.t0


def remesh(tree, rule_fn, new_mesh):
    """Re-shard a tree of tensors onto `new_mesh` using the same rule
    function.

    rule_fn(path, leaf) -> spec (`launch.sharding`). Works for both elastic
    grow and shrink because specs are expressed in axis names, not device
    counts. A leaf that is already a DTensor (on another mesh) is gathered
    first.
    """
    from torch.distributed.tensor import DTensor, distribute_tensor

    from ..launch.sharding import placements
    from ..weights import tree_map_with_path

    def place(path, leaf):
        spec = rule_fn(path, leaf)
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        return distribute_tensor(leaf, new_mesh, placements(spec, new_mesh))

    return tree_map_with_path(place, tree)
