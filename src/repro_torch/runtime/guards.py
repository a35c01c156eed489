"""Runtime guard: the opt-in finite check of `repro.runtime.guards`.

    check_finite("train step outs", outs)     # NaN or Inf -> error

It is a no-op unless REPRO_CHECK_FINITE=1, as in the JAX package:
inspecting a device tensor forces a host sync, so it stays opt-in. The JAX
package's other guard, `no_retrace`, counts XLA compilations; eager
PyTorch compiles nothing, so the port has no counterpart.
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
