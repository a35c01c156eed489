"""Ground-truth dataset generation + the content-hash shard store.

The port of `repro.train.data`. A corpus is declared as a
`repro_torch.scenarios` suite (or any list of `ScenarioSpec`s). Every
spec is a packet-level DES run (`get_backend("packet")`) followed by
host-side event-tensor assembly (`build_event_batch`); each becomes one
on-disk *shard* of a `DatasetStore` keyed by the content hash of
everything that determines its bytes: the materialized `SimRequest`
(topology, NetConfig, full flow list, packet seed `request_seed`) plus
the event-tensor layout (`snap_flows`/`snap_links`/`max_path`, the event
cap). A rebuild of an overlapping corpus builds only the missing keys.
The key formula is the JAX package's, so one spec has one shard key in
both packages, and the shard bytes are the same too: a store that either
package filled serves the other.

Shards build inline. The JAX package's worker pool is a `repro.fleet`
run, which the port has not yet: `workers > 1` raises rather than
quietly building inline.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.events import EventBatch, build_event_batch
from ..core.model import M4Config
from ..runtime.blobstore import BlobStore

_FORMAT_VERSION = 1   # bump to invalidate every shard (layout change)


def shard_key(spec, m4cfg: M4Config, *, max_events: Optional[int] = None,
              request_seed: int = 0) -> str:
    """Content hash of one training shard: the materialized request's
    `content_hash()` (flows + topology + NetConfig + packet seed), not
    the spec's name or spelling, so two specs that generate the same
    scenario share one shard; and the `EventBatch` layout knobs that
    change the tensor bytes."""
    request = spec.to_request(seed=request_seed)
    layout = (f"v{_FORMAT_VERSION}|sf:{m4cfg.snap_flows}"
              f"|sl:{m4cfg.snap_links}|p:{m4cfg.max_path}"
              f"|ev:{'all' if max_events is None else int(max_events)}")
    return hashlib.sha256(
        f"{request.content_hash()}|{layout}".encode()).hexdigest()


def dataset_key_from_shards(keys: Sequence[str]) -> str:
    """Aggregate corpus hash from shard keys (order-independent)."""
    return hashlib.sha256("|".join(sorted(keys)).encode()).hexdigest()


def dataset_key(specs: Sequence, m4cfg: M4Config, *,
                max_events: Optional[int] = None,
                request_seed: int = 0) -> str:
    """Aggregate content hash of a whole corpus (order-independent): it
    changes iff at least one shard's content key changes."""
    return dataset_key_from_shards(
        [shard_key(s, m4cfg, max_events=max_events,
                   request_seed=request_seed) for s in specs])


class DatasetStore(BlobStore):
    """Blob store of compressed `EventBatch` shards addressed by content
    key (the `to_arrays`/`from_arrays` contract in `core.events`)."""

    def _encode(self, batch: EventBatch) -> dict:
        return {
            name: (arr.dtype.str, list(arr.shape),
                   np.ascontiguousarray(arr).tobytes())
            for name, arr in batch.to_arrays().items()}

    def _decode(self, payload: dict) -> EventBatch:
        # .copy(): frombuffer views are read-only — a cache hit must be
        # as mutable as a freshly built batch
        arrays = {
            name: np.frombuffer(buf, np.dtype(dt)).reshape(shape).copy()
            for name, (dt, shape, buf) in payload.items()}
        return EventBatch.from_arrays(arrays)


def build_one(spec, m4cfg: M4Config, max_events: Optional[int] = None,
              request_seed: int = 0) -> EventBatch:
    """One spec -> packet ground truth -> event tensors (host numpy)."""
    from ..sim import get_backend
    trace = get_backend("packet").run(spec.to_request(seed=request_seed)).raw
    return build_event_batch(trace, m4cfg, max_events=max_events)


@dataclass
class DatasetReport:
    """What one `build_dataset` call did."""
    keys: List[str]
    hits: int
    misses: int
    wall_s: float
    root: str

    @property
    def hit_rate(self) -> float:
        return self.hits / max(len(self.keys), 1)

    @property
    def corpus_key(self) -> str:
        """The aggregate dataset hash (== `dataset_key` of the specs)."""
        return dataset_key_from_shards(self.keys)


def build_dataset(specs: Sequence, m4cfg: M4Config, root: str, *,
                  max_events: Optional[int] = None, workers: int = 0,
                  request_seed: int = 0,
                  log=None) -> Tuple[List[EventBatch], DatasetReport]:
    """Materialize the corpus: serve hits from the store, build misses
    inline, return batches in spec order plus a `DatasetReport`.
    A shard's bytes depend only on its content key (flows seeded by
    `spec.seed`, the DES by `request_seed`), so every miss is
    reproducible in isolation. `workers` of 0 or 1 builds inline; more
    raises, since the worker pool (the JAX package's `repro.fleet` run)
    is not ported."""
    if workers > 1:
        raise NotImplementedError(
            f"workers={workers}: the dataset worker pool is a fleet run, "
            "and the port has no fleet yet; pass workers=0 to build inline")
    specs = list(specs)
    store = DatasetStore(root)
    t0 = time.perf_counter()
    keys = [shard_key(s, m4cfg, max_events=max_events,
                      request_seed=request_seed) for s in specs]
    batches: List[Optional[EventBatch]] = [store.get(k) for k in keys]
    miss = [i for i, b in enumerate(batches) if b is None]
    if miss and log:
        log(f"[train.data] {len(specs) - len(miss)} cached, building "
            f"{len(miss)} shard(s) inline")
    for i in miss:
        store.put(keys[i], build_one(specs[i], m4cfg, max_events,
                                     request_seed))
        batches[i] = store.get(keys[i])
        if batches[i] is None:
            raise IOError(f"freshly built shard {keys[i][:12]} unreadable")
    report = DatasetReport(keys=keys, hits=len(specs) - len(miss),
                           misses=len(miss),
                           wall_s=time.perf_counter() - t0, root=root)
    if log:
        log(f"[train.data] corpus ready: {len(specs)} shard(s), "
            f"{report.hits} hit / {report.misses} built, "
            f"{report.wall_s:.1f}s")
    return batches, report
