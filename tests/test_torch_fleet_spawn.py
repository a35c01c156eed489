"""The port's fleet with spawned worker processes, on the CPU.

Each test runs a fleet of 2 spawn workers over a small smoke16 sweep of
the numpy `flowsim` backend (or a dataset build) and asserts only what
the fault plan decides: counts, lower bounds and cache bytes, never a
wall time. Every lease timeout is 3 s, ten times the heartbeat, so a
worker starved of CPU by a busy host is not reaped as dead; every wait
is bounded (`chunk_timeout_s`, and `timeout=` on the CLI subprocess).
A worker-targeted fault fires only if that worker claims a task, and a
fast worker can drain a small sweep before the other has started, so
kill and stall plans target both workers of the initial pool: whichever
claims first takes the fault.

Under pytest-xdist the worker process's `__main__` is execnet's bootstrap
(no `__file__`, no `__spec__`), so `_pool_usable()` says spawn can't
start and `SweepRunner(fleet=)` / `build_dataset(workers=)` would run
inline. Spawn re-imports nothing in that case, so the workers do start:
the tests that go through those two entry points patch `_pool_usable`
to say so. This module imports only the port at module level: a
spawned worker unpickling `ModulesProbeJob` imports it.
"""
import json
import os
import subprocess
import sys
from dataclasses import dataclass

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores

from repro_torch.fleet import (FleetConfig, SweepJob, parse_plan,  # noqa: E402
                               run_fleet, sweep_job_for, sweep_tasks)
from repro_torch.runtime.resilience import Backoff  # noqa: E402
from repro_torch.scenarios import SweepRunner, get_suite  # noqa: E402
from repro_torch.scenarios.cache import ResultCache, result_key  # noqa: E402
from repro_torch.sim import get_backend  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fast_config(**kw):
    """Supervision knobs for tests: lease timeout 3 s = 10 x heartbeat."""
    base = dict(workers=2, heartbeat_s=0.3, lease_timeout_s=3.0,
                poll_s=0.05, max_attempts=3, chunk_timeout_s=60.0,
                backoff=Backoff(base_s=0.05, factor=2.0, cap_s=0.3))
    base.update(kw)
    return FleetConfig(**base)


def sweep_fixture(n=6, num_flows=8):
    backend = get_backend("flowsim")
    specs = list(get_suite("smoke16", num_flows=num_flows).limit(n))
    reqs = [s.to_request() for s in specs]
    return backend, specs, reqs, [result_key(r, backend) for r in reqs]


def cache_bytes(cache_dir, keys):
    store = ResultCache(cache_dir)
    out = {}
    for k in keys:
        res = store.get(k)
        assert res is not None, f"missing cache entry {k[:12]}"
        out[k] = (res.fcts.tobytes(), res.slowdowns.tobytes())
    return out


def fleet_once(tmp_path, tag, chaos=None, n=6, job=None, **cfg_kw):
    backend, specs, reqs, keys = sweep_fixture(n=n)
    cache = str(tmp_path / f"cache_{tag}")
    job = job or sweep_job_for(backend, cache)
    tasks = sweep_tasks(specs, reqs, keys, 1)
    cfg = fast_config(coord_dir=str(tmp_path / f"coord_{tag}"), chaos=chaos,
                      **cfg_kw)
    return run_fleet(tasks, job, cfg), keys, cache


def inprocess_bytes(tmp_path, n=6):
    backend, specs, _, keys = sweep_fixture(n=n)
    cache = str(tmp_path / "inprocess")
    SweepRunner(backend, cache_dir=cache, chunk_size=1).run(specs)
    return cache_bytes(cache, keys)


@dataclass
class ModulesProbeJob(SweepJob):
    """A SweepJob that also writes its worker's `sys.modules` to a file."""
    modules_dir: str = ""

    def run(self, payload):
        super().run(payload)
        os.makedirs(self.modules_dir, exist_ok=True)
        path = os.path.join(self.modules_dir, f"{os.getpid()}.json")
        with open(path, "w") as f:
            json.dump(sorted(sys.modules), f)


def test_clean_fleet_equals_inprocess(tmp_path):
    metrics, keys, cache = fleet_once(tmp_path, "clean")
    assert metrics.total == metrics.done == metrics.computed == 6
    assert metrics.accounted == metrics.total and metrics.poisoned == 0
    assert metrics.workers_spawned == 2 and metrics.worker_restarts == 0
    assert cache_bytes(cache, keys) == inprocess_bytes(tmp_path)


def test_spawned_worker_imports_no_jax_and_no_repro(tmp_path):
    backend, specs, reqs, keys = sweep_fixture(n=4)
    cache = str(tmp_path / "cache")
    probe = str(tmp_path / "modules")
    job = ModulesProbeJob(backend_name="flowsim", cache_dir=cache,
                          modules_dir=probe)
    metrics, _, _ = fleet_once(tmp_path, "probe", n=4, job=job)
    assert metrics.done == 4
    files = os.listdir(probe)
    assert files
    for name in files:
        with open(os.path.join(probe, name)) as f:
            mods = json.load(f)
        assert "repro_torch.fleet.worker" in mods
        bad = [m for m in mods
               if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert bad == []


def test_relaunch_spawns_nothing(tmp_path):
    backend, specs, reqs, keys = sweep_fixture()
    cache = str(tmp_path / "cache")
    job = sweep_job_for(backend, cache)
    tasks = sweep_tasks(specs, reqs, keys, 1)
    cfg = fast_config(coord_dir=str(tmp_path / "coord"))
    first = run_fleet(tasks, job, cfg)
    assert first.computed == 6 and first.already_done == 0
    second = run_fleet(tasks, job, cfg)
    assert second.already_done == 6 and second.computed == 0
    assert second.workers_spawned == 0
    assert second.done == second.total == 6


def test_kill_and_corrupt_converge_bitwise(tmp_path):
    plan = parse_plan("kill:worker=0,after=1;kill:worker=1,after=1;"
                      "corrupt:task=1;raise:task=2,exc=oserror,times=1")
    metrics, keys, cache = fleet_once(tmp_path, "chaos", chaos=plan)
    assert metrics.done == metrics.total == 6 and metrics.poisoned == 0
    assert metrics.worker_restarts >= 1 and metrics.workers_spawned >= 3
    assert metrics.retried >= 2      # the killed chunk, corrupt, raise
    assert cache_bytes(cache, keys) == inprocess_bytes(tmp_path)
    corrupt = [f for _, _, fs in os.walk(cache) for f in fs
               if f.endswith(".corrupt")]
    assert len(corrupt) == 1         # quarantined aside, not deleted


def test_stalled_worker_is_reaped(tmp_path):
    plan = parse_plan("stall:worker=0,after=1;stall:worker=1,after=1")
    metrics, keys, cache = fleet_once(tmp_path, "stall", chaos=plan)
    assert metrics.done == metrics.total == 6
    assert metrics.kills >= 1 and metrics.lease_breaks >= 1
    assert metrics.retried >= 1
    assert cache_bytes(cache, keys) == inprocess_bytes(tmp_path)


def test_poisoned_chunk_surfaces_as_none_entry(tmp_path, monkeypatch):
    monkeypatch.setattr(tdata, "_pool_usable", lambda: True)
    runner = SweepRunner(
        get_backend("flowsim"), cache_dir=str(tmp_path / "cache"),
        chunk_size=1,
        fleet=fast_config(chaos=parse_plan("raise:task=1,exc=valueerror")))
    report = runner.run(get_suite("smoke16", num_flows=8).limit(4))
    assert report.fleet["poisoned"] == 1 and report.fleet["retried"] == 0
    assert report.fleet["accounted"] == report.fleet["total"] == 4
    (rec,) = report.fleet["poison"]
    assert rec["exc_type"] == "ValueError"
    assert rec["why"] == "deterministic failure"
    holes = [e for e in report.entries if e.result is None]
    assert len(holes) == 1
    rows = report.rows()
    assert sum(np.isnan(r["wall_s"]) for r in rows) == 1
    assert "4 scenarios" in report.table()


def test_sweeprunner_fleet_report_then_all_hits(tmp_path, monkeypatch):
    monkeypatch.setattr(tdata, "_pool_usable", lambda: True)
    backend = get_backend("flowsim")
    suite = get_suite("smoke16", num_flows=8).limit(4)
    runner = SweepRunner(backend, cache_dir=str(tmp_path / "cache"),
                         chunk_size=1, fleet=fast_config())
    report = runner.run(suite)
    assert report.fleet is not None
    assert report.fleet["done"] == report.fleet["accounted"] == 4
    assert report.fleet["workers_spawned"] == 2
    assert report.misses == 4
    assert all(e.result is not None for e in report.entries)
    again = runner.run(suite)
    assert again.hits == 4 and again.fleet is None
    for a, b in zip(report.entries, again.entries):
        assert a.result.fcts.tobytes() == b.result.fcts.tobytes()


def test_build_dataset_workers_equals_inline(tmp_path, monkeypatch):
    """Two fleet workers write the inline build's shard bytes, under the
    JAX package's shard keys."""
    from repro_torch.core.model import M4Config
    monkeypatch.setattr(tdata, "_pool_usable", lambda: True)
    gate = dict(hidden=16, gnn_dim=16, mlp_hidden=16, gnn_layers=2,
                snap_flows=16, snap_links=32)
    cfg = M4Config(**gate)
    specs = list(get_suite("smoke16", num_flows=8).limit(4))
    fleet_root, inline_root = str(tmp_path / "fleet"), str(tmp_path / "in")
    batches, rep = tdata.build_dataset(
        specs, cfg, fleet_root, max_events=40, workers=2,
        fleet=fast_config())
    assert rep.fleet is not None and rep.fleet["done"] == 4
    assert rep.fleet["workers_spawned"] == 2 and rep.misses == 4
    _, ref = tdata.build_dataset(specs, cfg, inline_root, max_events=40)
    assert ref.keys == rep.keys and ref.fleet is None
    for k in rep.keys:
        with open(tdata.DatasetStore(fleet_root)._path(k), "rb") as a, \
                open(tdata.DatasetStore(inline_root)._path(k), "rb") as b:
            assert a.read() == b.read()
    pytest.importorskip("jax")
    from repro.core.model import M4Config as JaxM4Config
    from repro.scenarios import get_suite as jax_suite
    from repro.train.data import shard_key as jax_shard_key
    jspecs = list(jax_suite("smoke16", num_flows=8).limit(4))
    assert rep.keys == [jax_shard_key(s, JaxM4Config(**gate), max_events=40)
                        for s in jspecs]


def test_cli_kill_plan_expect_clean(tmp_path):
    out = str(tmp_path / "metrics.json")
    cmd = [sys.executable, "-m", "repro_torch.fleet", "--suite", "smoke16",
           "--num-flows", "8", "--limit", "4", "--backend", "flowsim_fast",
           "--device", "cpu", "--workers", "2", "--chunk", "1",
           "--cache-dir", str(tmp_path / "cache"), "--lease-timeout", "3",
           "--heartbeat", "0.3", "--chunk-timeout", "60",
           "--chaos", "kill:worker=0,after=1;kill:worker=1,after=1",
           "--expect-clean",
           "--metrics-out", out]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(out) as f:
        m = json.load(f)
    assert m["done"] == m["accounted"] == m["total"] == 4
    assert m["worker_restarts"] >= 1 and m["poisoned"] == 0
