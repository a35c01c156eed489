"""Content-hash-keyed on-disk cache of sweep results.

A copy of `repro.scenarios.cache` on the port's `BlobStore`. The unit of
caching is one (SimRequest, backend fingerprint) pair, keyed by
`SimRequest.content_hash()`, so the key survives process restarts and two
specs that materialize the same flows share one entry. Keys and entry
bytes follow the JAX package's formula: the `packet` and `flowsim`
backends, whose fingerprints are the same names in both packages and
whose outputs are bitwise equal, share entries with the JAX package's
cache (it writes zstd, which the port reads through `runtime.zstd`; the
port writes zlib, which the JAX package reads). m4 and `flowsim_fast`
carry `_torch` fingerprints, so their entries never mix packages.
Entries carry the fcts/slowdowns/wall-time triple of a `SimResult`
(never `raw`: backend-native objects don't round-trip).
"""
from __future__ import annotations

import hashlib

import numpy as np

from ..runtime.blobstore import BlobStore
from ..sim.api import SimRequest, SimResult


def result_key_raw(content_hash: str, fingerprint: str) -> str:
    """Cache key from a request content hash and a backend fingerprint
    *string*."""
    return hashlib.sha256(f"{content_hash}:{fingerprint}".encode()).hexdigest()


def result_key(request: SimRequest, backend) -> str:
    """Cache key: request content x backend identity (name + weights hash
    for parameterized backends — see `Backend.fingerprint`)."""
    return result_key_raw(request.content_hash(), backend.fingerprint())


class ResultCache(BlobStore):
    """Blob store of compressed `SimResult`s addressed by content key."""

    def _encode(self, result: SimResult) -> dict:
        dt = np.float64
        return {
            "dtype": np.dtype(dt).str,
            "fcts": np.ascontiguousarray(result.fcts, dt).tobytes(),
            "slowdowns": np.ascontiguousarray(result.slowdowns, dt).tobytes(),
            "wall_time": float(result.wall_time),
            "backend": result.backend,
        }

    def _decode(self, payload: dict) -> SimResult:
        fcts = np.frombuffer(payload["fcts"],
                             np.dtype(payload["dtype"])).copy()
        sldn = np.frombuffer(payload["slowdowns"],
                             np.dtype(payload["dtype"])).copy()
        return SimResult(fcts=fcts, slowdowns=sldn,
                         wall_time=payload["wall_time"],
                         backend=payload["backend"])
