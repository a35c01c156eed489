"""Filesystem coordination spine for a fleet run (`repro_torch.fleet.coord`).

The port's copy of `repro.fleet.coord`, on the port's `LeaseDir`: the
same files with the same JSON, so either package reads a directory the
other wrote. Everything workers and the supervisor agree on lives in one
directory (shared-fs friendly, as the blob store assumes):

    <coord>/leases/<task>.lease   atomic claims + heartbeat mtime
    <coord>/done/<task>.json      completion records (owner, wall_s, ...)
    <coord>/err/<task>.json       last failure (traceback, retryable flag)
    <coord>/poison/<task>.json    quarantine manifests (permanent)
    <coord>/chaos/                one-shot fault fired-markers
    <coord>/metrics.json          supervisor's final FleetMetrics
    <coord>/obs_snapshot.json     the run as a repro.obs/1 snapshot

All records are plain JSON written tmp+rename, so readers never see a
torn file. Markers carry *bookkeeping*; the results themselves go
through the content-addressed blob store (ResultCache/DatasetStore), and
the supervisor re-verifies blobs behind done markers before trusting
them — a done marker whose results were quarantined gets cleared and
the chunk requeued.
"""
from __future__ import annotations

import json
import os
import tempfile
import traceback
from typing import Dict, List, Optional

from ..runtime.blobstore import LeaseDir


def _write_json(path: str, obj: dict):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=1)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class Coordinator:
    """One fleet run's view of the coordination directory."""

    def __init__(self, root: str):
        self.root = root
        self.leases = LeaseDir(os.path.join(root, "leases"))
        self.chaos_dir = os.path.join(root, "chaos")
        for sub in ("leases", "done", "err", "poison", "chaos"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)

    def _marker(self, kind: str, task_id: str) -> str:
        return os.path.join(self.root, kind, task_id + ".json")

    # ------------------------------------------------------------- done
    def is_done(self, task_id: str) -> bool:
        return os.path.exists(self._marker("done", task_id))

    def mark_done(self, task_id: str, owner: str, wall_s: float,
                  attempt: int, extra: Optional[Dict] = None):
        """`extra` (e.g. a job's `done_extra` divergence stamp) merges
        into the record; the four bookkeeping keys always win."""
        rec = dict(extra or {})
        rec.update({"task": task_id, "owner": owner,
                    "wall_s": wall_s, "attempt": attempt})
        _write_json(self._marker("done", task_id), rec)

    def done_record(self, task_id: str) -> Optional[dict]:
        return _read_json(self._marker("done", task_id))

    def clear_done(self, task_id: str):
        """Retract a done marker whose results failed verification."""
        try:
            os.remove(self._marker("done", task_id))
        except OSError:
            pass

    # ------------------------------------------------------------ errors
    def has_error(self, task_id: str) -> bool:
        return os.path.exists(self._marker("err", task_id))

    def mark_error(self, task_id: str, owner: str, exc: BaseException,
                   retryable: bool):
        _write_json(self._marker("err", task_id),
                    {"task": task_id, "owner": owner,
                     "exc_type": type(exc).__name__, "exc": str(exc),
                     "retryable": retryable,
                     "traceback": traceback.format_exc()})

    def synthetic_error(self, task_id: str, owner: str, why: str):
        """Out-of-band failure (dead pid, stale lease): no exception
        object exists, but the chunk still needs a retryable err record."""
        _write_json(self._marker("err", task_id),
                    {"task": task_id, "owner": owner,
                     "exc_type": "WorkerDied", "exc": why,
                     "retryable": True, "traceback": ""})

    def error_record(self, task_id: str) -> Optional[dict]:
        return _read_json(self._marker("err", task_id))

    def clear_error(self, task_id: str):
        try:
            os.remove(self._marker("err", task_id))
        except OSError:
            pass

    # ------------------------------------------------------------ poison
    def is_poisoned(self, task_id: str) -> bool:
        return os.path.exists(self._marker("poison", task_id))

    def mark_poison(self, task_id: str, record: dict):
        _write_json(self._marker("poison", task_id), record)

    def poison_record(self, task_id: str) -> Optional[dict]:
        return _read_json(self._marker("poison", task_id))

    def poison_manifest(self) -> List[dict]:
        pdir = os.path.join(self.root, "poison")
        out = []
        for name in sorted(os.listdir(pdir)):
            if name.endswith(".json"):
                rec = _read_json(os.path.join(pdir, name))
                if rec is not None:
                    out.append(rec)
        return out

    # ----------------------------------------------------------- metrics
    def write_metrics(self, metrics: Dict):
        _write_json(os.path.join(self.root, "metrics.json"), metrics)

    def read_metrics(self) -> Optional[dict]:
        return _read_json(os.path.join(self.root, "metrics.json"))

    def write_obs(self, snapshot: Dict):
        """Persist the run's `repro.obs/1` snapshot next to metrics.json
        (input to `python -m repro_torch.obs --merge`)."""
        _write_json(os.path.join(self.root, "obs_snapshot.json"), snapshot)

    def read_obs(self) -> Optional[dict]:
        return _read_json(os.path.join(self.root, "obs_snapshot.json"))
