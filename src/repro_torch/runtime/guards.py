"""Runtime guards: compile-count budgets and opt-in finite checks, as in
`repro.runtime.guards`.

`no_retrace` catches what a static check cannot see — an arena shape
leaking into a key, a config that stopped comparing equal — from the
`TRACE_COUNTS` counters of the two event loops and of the training step,
which move by one for each new compiled program
(`repro_torch.core.compiled`: a captured CUDA graph on a card, a
prepared eager step on the CPU). Wrap a stage that
should reuse its programs:

    with no_retrace(allowed=1, label="sweep chunk"):
        backend.run_chunked(requests, chunk_size)

`allowed` is the number of *new* programs the block may build; more
raises `RetraceError` naming the counters that moved.

Finite checks are opt-in via REPRO_CHECK_FINITE=1 (they host-sync every
leaf they inspect, so the call sites stay free no-ops by default):

    check_finite("train step outs", outs)     # NaN or Inf -> error
    check_result_finite("m4", result)         # SimResult semantics

SimResult health is looser than strict finiteness on purpose: NaN is the
documented "flow never finished" value, so a result is unhealthy only if
it contains Inf or is NaN wall-to-wall.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Dict, Mapping, Optional

import numpy as np

from ..weights import leaf_numpy, tree_leaves


class RetraceError(AssertionError):
    """A guarded block compiled more than its budget allows."""


class NonFiniteError(AssertionError):
    """A guarded value contained NaN/Inf where it must not."""


def _default_counters() -> Dict[str, Mapping[str, int]]:
    """The port's three compile-counter families, imported lazily."""
    from ..core import flowsim_fast, simulate
    from ..train import loop as train_loop
    return {"core.simulate": simulate.TRACE_COUNTS,
            "core.flowsim_fast": flowsim_fast.TRACE_COUNTS,
            "train.loop": train_loop.TRACE_COUNTS}


def trace_total(counters: Optional[Mapping[str, Mapping[str, int]]] = None,
                ) -> int:
    """Total compiled programs recorded across the given counter families
    (default: every TRACE_COUNTS of the port)."""
    counters = counters if counters is not None else _default_counters()
    return sum(sum(c.values()) for c in counters.values())


def _snapshot(counters: Mapping[str, Mapping[str, int]]
              ) -> Dict[str, Dict[str, int]]:
    return {fam: dict(c) for fam, c in counters.items()}


@contextmanager
def no_retrace(allowed: int = 0,
               counters: Optional[Mapping[str, Mapping[str, int]]] = None,
               label: str = ""):
    """Assert the block builds at most `allowed` new compiled programs.

    `counters` maps family name -> TRACE_COUNTS-style mapping; pass a
    subset when the block legitimately compiles in another family. Each
    block counts `guards.no_retrace.blocks`, its new programs
    `guards.no_retrace.compiles` and a broken budget
    `guards.no_retrace.violations` in the obs registry."""
    counters = counters if counters is not None else _default_counters()
    before = _snapshot(counters)
    yield
    deltas, new = [], 0
    for fam, cnt in counters.items():
        for key, val in cnt.items():
            delta = val - before[fam].get(key, 0)
            if delta > 0:
                deltas.append(f"{fam}.{key}: +{delta}")
                new += delta
    from ..obs.registry import get_registry
    reg = get_registry()
    reg.inc("guards.no_retrace.blocks")
    if new:
        reg.inc("guards.no_retrace.compiles", new)
    if new > allowed:
        reg.inc("guards.no_retrace.violations")
        where = f" in {label}" if label else ""
        raise RetraceError(
            f"{new} compilation(s){where} where at most {allowed} "
            f"allowed ({', '.join(deltas)}) — a static arg or arena "
            "shape is varying across calls (see docs/ANALYSIS.md)")


def finite_checks_enabled() -> bool:
    return os.environ.get("REPRO_CHECK_FINITE", "") not in ("", "0")


def check_finite(label: str, tree, allow_nan: bool = False) -> None:
    """Raise NonFiniteError if any floating leaf of `tree` (tensors or
    arrays) contains Inf (or NaN unless allowed). No-op unless
    REPRO_CHECK_FINITE=1."""
    if not finite_checks_enabled():
        return
    for path, leaf in tree_leaves(tree):
        arr = leaf_numpy(leaf)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        bad = np.isinf(arr) if allow_nan else ~np.isfinite(arr)
        if bad.any():
            kind = "Inf" if allow_nan else "NaN/Inf"
            raise NonFiniteError(
                f"{label}: {int(bad.sum())} {kind} value(s) at leaf "
                f"{path or '<root>'} (shape {arr.shape})")


def check_result_finite(label: str, result) -> None:
    """SimResult health: NaN marks a legally-unfinished flow, so flag only
    Inf anywhere or an entirely-NaN fct vector (every flow 'unfinished' is
    a simulator bug, not a traffic pattern). No-op unless
    REPRO_CHECK_FINITE=1."""
    if not finite_checks_enabled():
        return
    for name in ("fcts", "slowdowns"):
        arr = np.asarray(getattr(result, name))
        if np.isinf(arr).any():
            raise NonFiniteError(
                f"{label}: SimResult.{name} contains "
                f"{int(np.isinf(arr).sum())} Inf value(s)")
        if arr.size and np.isnan(arr).all():
            raise NonFiniteError(
                f"{label}: SimResult.{name} is all-NaN over {arr.size} "
                "flow(s) — no flow ever completed")
