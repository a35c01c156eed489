"""Runtime guards: the opt-in finite checks of `repro.runtime.guards`.

    check_finite("train step outs", outs)     # NaN or Inf -> error
    check_result_finite("m4", result)         # SimResult semantics

They are no-ops unless REPRO_CHECK_FINITE=1, as in the JAX package:
inspecting a device tensor forces a host sync, so they stay opt-in.
SimResult health is looser than strict finiteness on purpose: NaN is the
documented "flow never finished" value, so a result is unhealthy only if
it contains Inf or is NaN wall-to-wall. The JAX package's other guard,
`no_retrace`, counts XLA compilations; its twin for the port waits for
graph capture, which is what would count.
"""
from __future__ import annotations

import os

import numpy as np

from ..weights import leaf_numpy, tree_leaves


class NonFiniteError(AssertionError):
    """A guarded value contained NaN/Inf where it must not."""


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
