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

Cache misses fan out across worker *processes* when `workers > 1` (the
DES is pure Python and CPU-bound, so threads won't do): the pool is a
`repro_torch.fleet` run, one task per missing shard with the store as
the result channel, so a multi-worker build inherits lease-based
claiming, crash and straggler reaping and retry with backoff, and a
killed build resumes from the shards that completed. Workers are
spawned, never forked (a parent with a live CUDA context cannot fork);
the DES runs on the host, so they never touch the card.
"""
from __future__ import annotations

import hashlib
import os
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


def _pool_usable() -> bool:
    """True when spawn()ed workers can actually start: the spawn start
    method re-imports `__main__`, so a parent running from stdin or a
    REPL (no importable main module) would wedge the pool — build
    inline there instead. The JAX package's rule."""
    import sys
    main = sys.modules.get("__main__")
    if main is None:
        return False
    if getattr(main, "__spec__", None) is not None:   # python -m ...
        return True
    path = getattr(main, "__file__", None)
    return bool(path) and os.path.exists(path)


@dataclass
class DatasetReport:
    """What one `build_dataset` call did."""
    keys: List[str]
    hits: int
    misses: int
    wall_s: float
    root: str
    fleet: Optional[dict] = None   # FleetMetrics of a multi-worker build

    @property
    def hit_rate(self) -> float:
        return self.hits / max(len(self.keys), 1)

    @property
    def corpus_key(self) -> str:
        """The aggregate dataset hash (== `dataset_key` of the specs)."""
        return dataset_key_from_shards(self.keys)


def build_dataset(specs: Sequence, m4cfg: M4Config, root: str, *,
                  max_events: Optional[int] = None, workers: int = 0,
                  request_seed: int = 0, fleet=None,
                  log=None) -> Tuple[List[EventBatch], DatasetReport]:
    """Materialize the corpus: serve hits from the store, fan misses
    across `workers` supervised fleet processes (0/1 = build inline),
    return batches in spec order plus a `DatasetReport`.

    Multi-worker builds run as a `repro_torch.fleet` job (one task per
    missing shard, the store as the result channel), so a crashed or
    wedged worker costs a retry, not the build. A shard that fails
    deterministically is quarantined to the fleet's poison manifest and
    reported here as an IOError naming it (a corpus with holes can't
    train). `fleet` takes a `FleetConfig` to override supervision knobs
    (its `workers` wins over the `workers` argument). Without an
    importable `__main__` (stdin, a REPL) spawn workers can't start and
    the build runs inline.

    A shard's bytes depend only on its content key (flows seeded by
    `spec.seed`, the DES by `request_seed`), so inline and fleet builds
    of one corpus write the same bytes, and every miss is reproducible
    in isolation.
    """
    specs = list(specs)
    store = DatasetStore(root)
    t0 = time.perf_counter()
    keys = [shard_key(s, m4cfg, max_events=max_events,
                      request_seed=request_seed) for s in specs]
    batches: List[Optional[EventBatch]] = [store.get(k) for k in keys]
    miss = [i for i, b in enumerate(batches) if b is None]
    fleet_metrics = None
    if miss:
        if log:
            log(f"[train.data] {len(specs) - len(miss)} cached, building "
                f"{len(miss)} shard(s) with {max(workers, 1)} worker(s)")
        use_pool = (fleet is not None or (workers and workers > 1)) \
            and len(miss) > 1
        if use_pool and not _pool_usable():
            if log:
                log("[train.data] no importable __main__ (stdin/REPL) — "
                    "spawn workers unavailable, building inline")
            use_pool = False
        if use_pool:
            from ..fleet import (DatasetJob, FleetConfig, dataset_tasks,
                                 default_coord_dir, run_fleet)
            job = DatasetJob(root=root, m4cfg=m4cfg, max_events=max_events,
                             request_seed=request_seed)
            tasks = dataset_tasks([specs[i] for i in miss],
                                  [keys[i] for i in miss])
            config = fleet if fleet is not None \
                else FleetConfig(workers=min(workers, len(miss)))
            if config.coord_dir is None:
                config = config.with_coord_dir(
                    default_coord_dir(root, tasks))
            fleet_metrics = run_fleet(tasks, job, config, log=log).as_dict()
            for i in miss:
                batches[i] = store.get(keys[i])
                if batches[i] is None:
                    raise IOError(
                        f"shard {keys[i][:12]} missing after fleet build "
                        f"({fleet_metrics['poisoned']} shard(s) poisoned — "
                        f"see {config.coord_dir}/poison/)")
        else:
            for i in miss:
                store.put(keys[i], build_one(specs[i], m4cfg, max_events,
                                             request_seed))
                batches[i] = store.get(keys[i])
                if batches[i] is None:
                    raise IOError(
                        f"freshly built shard {keys[i][:12]} unreadable")
    report = DatasetReport(keys=keys, hits=len(specs) - len(miss),
                           misses=len(miss),
                           wall_s=time.perf_counter() - t0, root=root,
                           fleet=fleet_metrics)
    if log:
        log(f"[train.data] corpus ready: {len(specs)} shard(s), "
            f"{report.hits} hit / {report.misses} built, "
            f"{report.wall_s:.1f}s")
    return batches, report
