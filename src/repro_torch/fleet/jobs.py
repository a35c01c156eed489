"""Fleet job types: what one claimed chunk actually *does*.

A `FleetJob` is a picklable strategy object shipped to every spawned
worker once; each claimed task hands it a small payload (a chunk of
scenario specs, or one dataset shard spec). The contract that makes the
whole fleet crash-safe:

- `run(payload)` writes results **only** through the content-addressed
  blobstore (`ResultCache` / `DatasetStore`): atomic, idempotent,
  keyed by content. Two workers racing the same chunk (a broken lease)
  just write identical bytes twice.
- `verify(payload)` re-reads every result key through the store's
  integrity-checked `get` and returns the keys that are missing or
  corrupt — the worker retries (raising a retryable IOError) and the
  supervisor re-verifies behind done markers, so a torn or bit-flipped
  blob heals instead of surviving into a consumer.
- `result_paths(payload)` names the blob files a task writes (the chaos
  harness corrupts these; nothing else uses it).

The port's copy of `repro.fleet.jobs`. Its task ids, keys and payloads
are the JAX package's. What the card adds: `sweep_job_for` ships m4's
weights as numpy arrays, never tensors (a CUDA tensor in a spawn payload
would initialise CUDA while the worker unpickles its arguments, or fail
on a host with no card), and the job carries the backend's `device`. A
worker rebuilds the backend with
`get_backend(name, params=..., cfg=..., device=...)`, so its
`fingerprint()` is the dispatcher's (`m4_torch-<digest>-kcuda`) and it
writes exactly the keys an in-process sweep writes. Module import stays
light: the simulators and torch load inside `run`.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

Task = Tuple[str, dict]     # (task_id, payload)


class FleetJob:
    """Base strategy: subclasses define the three methods below and must
    be picklable (spawn start method ships them to workers by value)."""

    #: where the job computes: "cuda" makes `run_fleet` build the
    #: kernels once before it spawns workers
    device: str = "cpu"

    def run(self, payload: dict) -> None:
        """Compute the task and persist results through the blobstore."""
        raise NotImplementedError

    def verify(self, payload: dict) -> List[str]:
        """Result keys of `payload` that are missing/unreadable on disk."""
        raise NotImplementedError

    def result_paths(self, payload: dict) -> List[str]:
        """Blob file paths this task writes (chaos corruption targets)."""
        raise NotImplementedError

    def done_extra(self, payload: dict) -> Optional[dict]:
        """Optional bookkeeping merged into the task's done marker after a
        verified run (e.g. per-scenario divergence). Pure telemetry: the
        worker treats a failure here as 'no extra', never as a task
        failure."""
        return None


# ------------------------------------------------------------------ sweeps
@dataclass
class SweepJob(FleetJob):
    """One task = one shape-compatible chunk of a scenario sweep.

    The payload carries the chunk's specs *and* their precomputed result
    keys (`result_key(request, backend)` — computed once by the
    dispatcher, where the backend object exists). The worker rebuilds
    the backend from `backend_name` + `backend_kwargs` (numpy weights
    and `device` included) on first use and runs the chunk as a single
    `run_many` batch — the same batching `Backend.run_chunked` does, so
    fleet and in-process sweeps produce identical per-chunk results.
    """
    backend_name: str
    cache_dir: str
    backend_kwargs: Dict[str, Any] = field(default_factory=dict)
    request_options: Dict[str, Any] = field(default_factory=dict)
    # oracle backend *fingerprint* (see `Backend.fingerprint`): when set,
    # `done_extra` scores each scenario against the oracle's cached result
    # and the divergence rides into the task's done marker
    diff_against: Optional[str] = None

    @property
    def device(self) -> str:
        return str(self.backend_kwargs.get("device", "cpu"))

    def _backend(self):
        be = getattr(self, "_backend_obj", None)
        if be is None:
            from ..sim import get_backend
            kwargs = dict(self.backend_kwargs)
            if "params" in kwargs:          # numpy leaves -> CPU tensors
                import torch
                from ..weights import tree_map
                kwargs["params"] = tree_map(torch.from_numpy,
                                            kwargs["params"])
            be = get_backend(self.backend_name, **kwargs)
            self._backend_obj = be
        return be

    def _store(self):
        from ..scenarios.cache import ResultCache
        return ResultCache(self.cache_dir)

    def run(self, payload: dict) -> None:
        from ..obs.trace import get_tracer
        tracer = get_tracer()
        store = self._store()
        with tracer.span("fleet.build",
                         attrs={"n": len(payload["specs"]),
                                "backend": self.backend_name}):
            requests = [s.to_request(**self.request_options)
                        for s in payload["specs"]]
            results = self._backend().run_many(requests)
        with tracer.span("fleet.cache-write",
                         attrs={"n": len(payload["keys"])}):
            for key, res in zip(payload["keys"], results):
                store.put(key, res)

    def verify(self, payload: dict) -> List[str]:
        store = self._store()
        return [k for k in payload["keys"] if store.get(k) is None]

    def result_paths(self, payload: dict) -> List[str]:
        store = self._store()
        return [store._path(k) for k in payload["keys"]]

    def done_extra(self, payload: dict) -> Optional[dict]:
        """Per-scenario mean relative FCT error against `diff_against`'s
        cache entries — only for scenarios the oracle has already
        simulated into the same cache (a missing oracle entry is silently
        skipped: divergence is opportunistic bookkeeping, not a gate)."""
        if not self.diff_against:
            return None
        from ..obs.diff import flow_rel_err
        from ..scenarios.cache import result_key_raw
        store = self._store()
        div: Dict[str, float] = {}
        for spec, key in zip(payload["specs"], payload["keys"]):
            mine = store.get(key)
            if mine is None:
                continue
            req = spec.to_request(**self.request_options)
            oracle = store.get(result_key_raw(req.content_hash(),
                                              self.diff_against))
            if oracle is None:
                continue
            err = flow_rel_err(mine.fcts, oracle.fcts)
            div[spec.label] = round(float(err.mean()), 6) if err.size else 0.0
        return {"divergence": div} if div else None


def sweep_job_for(backend, cache_dir: str,
                  request_options: Optional[dict] = None,
                  diff_against: Optional[str] = None) -> SweepJob:
    """Build a `SweepJob` from a live backend object.

    The host backends (`packet`, `flowsim`) ship as just their name;
    `flowsim_fast` also ships its device, and m4 its parameters
    (numpy-ified), config and device. Spawn workers rebuild it with
    `get_backend("m4", params=..., cfg=..., device=...)` and, because
    `fingerprint` hashes the weights and names the device, write to the
    exact same cache keys.
    """
    kwargs: Dict[str, Any] = {}
    device = getattr(backend, "device", None)
    if device is not None:
        kwargs["device"] = str(device)
    if backend.name == "m4":
        from ..weights import params_to_numpy
        kwargs.update(params=params_to_numpy(backend.params),
                      cfg=backend.cfg)
    return SweepJob(backend_name=backend.name, cache_dir=cache_dir,
                    backend_kwargs=kwargs,
                    request_options=dict(request_options or {}),
                    diff_against=diff_against)


def sweep_tasks(specs: Sequence, requests: Sequence, keys: Sequence[str],
                chunk_size: Optional[int]) -> List[Task]:
    """Partition a sweep's cache misses into fleet tasks.

    Replicates `Backend.run_chunked`'s arena-footprint sort — ascending
    (num_flows, num_links), sliced into `chunk_size` chunks — so every
    chunk pads to near-uniform shapes and a fleet run batches exactly
    like an in-process `run_chunked` would. Task ids hash the chunk's
    result keys: content-stable, so a relaunched fleet (or a different
    worker count) maps the same work to the same lease/done markers.
    """
    order = sorted(range(len(requests)),
                   key=lambda i: (requests[i].num_flows,
                                  requests[i].topo.num_links))
    size = chunk_size or len(order) or 1
    tasks: List[Task] = []
    for lo in range(0, len(order), size):
        chunk = order[lo:lo + size]
        chunk_keys = tuple(keys[i] for i in chunk)
        task_id = hashlib.sha256("|".join(chunk_keys).encode()).hexdigest()
        tasks.append((task_id, {
            "specs": tuple(specs[i] for i in chunk),
            "keys": chunk_keys,
        }))
    return tasks


# ----------------------------------------------------------------- datasets
@dataclass
class DatasetJob(FleetJob):
    """One task = one ground-truth dataset shard (packet DES + event
    tensor assembly), persisted to the `DatasetStore`: the worker pool of
    `repro_torch.train.data.build_dataset`, so dataset builds inherit
    retry/poison/straggler handling. The DES runs on the host: these
    workers never touch the card."""
    root: str
    m4cfg: Any                  # M4Config (picklable dataclass)
    max_events: Optional[int] = None
    request_seed: int = 0

    def _store(self):
        from ..train.data import DatasetStore
        return DatasetStore(self.root)

    def run(self, payload: dict) -> None:
        from ..obs.trace import get_tracer
        from ..train.data import build_one
        tracer = get_tracer()
        with tracer.span("fleet.build", attrs={"kind": "dataset"}):
            batch = build_one(payload["spec"], self.m4cfg,
                              self.max_events, self.request_seed)
        with tracer.span("fleet.cache-write"):
            self._store().put(payload["key"], batch)

    def verify(self, payload: dict) -> List[str]:
        return [] if self._store().get(payload["key"]) is not None \
            else [payload["key"]]

    def result_paths(self, payload: dict) -> List[str]:
        return [self._store()._path(payload["key"])]


def dataset_tasks(specs: Sequence, keys: Sequence[str]) -> List[Task]:
    """One fleet task per missing shard; the shard key is already a
    content hash, so it doubles as the task id."""
    return [(key, {"spec": spec, "key": key})
            for spec, key in zip(specs, keys)]
