"""The port's fleet (`repro_torch.fleet`) against the JAX package's
(`repro.fleet`), on the CPU and in the test process (no spawn: the
spawned fleet is tests/test_torch_fleet_spawn.py).

- `parse_plan` gives JAX's faults for every DSL string of the chaos
  module's docstring, and rejects what JAX rejects; one-shot fault
  markers are the same files, so a fault fired by one package is spent
  for the other;
- `sweep_tasks`, `task_set_digest` and `default_coord_dir` for the numpy
  `flowsim` backend (fingerprint "flowsim" in both packages, so the
  result keys agree) over smoke16 give JAX's task ids, at every chunk
  size; `dataset_tasks` and the shard keys too;
- a coordination directory written through either package's
  `Coordinator` and `LeaseDir` reads the same through the other's;
  `FleetMetrics` exports JAX's dict and obs snapshot;
- the port's `worker_entry`, run in this process over a `flowsim` and a
  `flowsim_fast` job, fills a cache whose bytes equal an in-process
  `run_chunked`; for `flowsim` they also equal JAX's `run_chunked`
  under the same keys. A `DatasetJob` writes the inline build's shard
  bytes;
- both packages' `divergence_from_coord` agree on the port's stamped
  done markers, and both `--check --coord` CLIs agree on a coordination
  directory and trace written by either package;
- `SweepRunner(fleet=)` needs a cache, refuses record_events, and falls
  back to the in-process path when spawn workers can't start, as JAX's.

Equality is exact throughout; wall times are never compared."""
import dataclasses
import json
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.fleet as jfleet  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.obs.__main__ import main as jax_obs_main  # noqa: E402
from repro.obs.diff import divergence_from_coord as jax_divergence  # noqa: E402
from repro.scenarios import get_suite as jax_suite  # noqa: E402
from repro.scenarios.cache import ResultCache as JaxCache  # noqa: E402
from repro.scenarios.cache import result_key as jax_result_key  # noqa: E402
from repro.sim import get_backend as jax_backend  # noqa: E402
from repro_torch import fleet  # noqa: E402
from repro_torch.core.model import M4Config, init_m4  # noqa: E402
from repro_torch.obs import trace as ptrace  # noqa: E402
from repro_torch.obs.__main__ import main as obs_main  # noqa: E402
from repro_torch.obs.diff import divergence_from_coord, flow_rel_err  # noqa: E402
from repro_torch.runtime.blobstore import LeaseDir  # noqa: E402
from repro_torch.scenarios import SweepRunner, get_suite  # noqa: E402
from repro_torch.scenarios.cache import ResultCache, result_key  # noqa: E402
from repro_torch.sim import get_backend  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402

CHAOS_DSL = [
    "kill:worker=0,after=2",
    "kill:worker=1,after=1,where=post",
    "stall:worker=0,after=1",
    "corrupt:task=5",
    "raise:task=3,exc=oserror,times=2",
    "raise:task=2,exc=valueerror",
    "kill:worker=0,after=2;corrupt:task=5",
    "kill:worker=0,after=1;corrupt:task=1;raise:task=2,exc=oserror,times=1",
    " kill:worker=0 ; ; stall:worker=1,after=3 ",
    "",
]
BAD_DSL = ["explode:worker=0", "kill:after=2", "corrupt:worker=1",
           "raise:task=0,exc=nonsense", "kill:worker=0,where=mid",
           "kill:worker"]
GATE = dict(hidden=16, gnn_dim=16, mlp_hidden=16, gnn_layers=2,
            snap_flows=16, snap_links=32)


def _faults(plan):
    return [(dataclasses.asdict(f), f.fault_id) for f in plan.faults]


@pytest.mark.parametrize("spec", CHAOS_DSL)
@pytest.mark.parametrize("seed", [0, 7])
def test_parse_plan_equals_jax(spec, seed):
    mine, ref = fleet.parse_plan(spec, seed=seed), \
        jfleet.parse_plan(spec, seed=seed)
    assert _faults(mine) == _faults(ref)
    assert (mine.seed, mine.spec, bool(mine)) == \
        (ref.seed, ref.spec, bool(ref))


@pytest.mark.parametrize("spec", BAD_DSL)
def test_parse_plan_rejects_as_jax(spec):
    with pytest.raises(ValueError):
        jfleet.parse_plan(spec)
    with pytest.raises(ValueError):
        fleet.parse_plan(spec)


def test_chaos_markers_are_shared_with_jax(tmp_path):
    chaos = str(tmp_path / "chaos")
    plan = "raise:task=0,exc=oserror,times=2"
    ref = jfleet.ChaosMonkey(jfleet.parse_plan(plan), 0, chaos, ["t1", "t0"])
    mine = fleet.ChaosMonkey(fleet.parse_plan(plan), 0, chaos, ["t0", "t1"])
    with pytest.raises(OSError):
        ref.on_run("t0")            # JAX fires the first slot
    with pytest.raises(OSError):
        mine.on_run("t0")           # the port the second
    ref.on_run("t0")                # both slots spent, fleet-wide
    mine.on_run("t0")
    mine.on_run("t1")               # untargeted task: inert
    assert sorted(os.listdir(chaos)) == [
        "raise-wNone-a1-t0-oserror-pre.0", "raise-wNone-a1-t0-oserror-pre.1"]


def _sweep(pkg, n=16, num_flows=8):
    """(specs, requests, keys) of a flowsim sweep in one package."""
    if pkg == "jax":
        be, suite, key = jax_backend("flowsim"), jax_suite, jax_result_key
    else:
        be, suite, key = get_backend("flowsim"), get_suite, result_key
    specs = list(suite("smoke16", num_flows=num_flows).limit(n))
    reqs = [s.to_request() for s in specs]
    return be, specs, reqs, [key(r, be) for r in reqs]


@pytest.mark.parametrize("chunk", [None, 1, 3, 4, 8])
def test_sweep_tasks_equal_jax(chunk, tmp_path):
    _, jspecs, jreqs, jkeys = _sweep("jax")
    _, specs, reqs, keys = _sweep("port")
    assert keys == jkeys
    mine = fleet.sweep_tasks(specs, reqs, keys, chunk)
    ref = jfleet.sweep_tasks(jspecs, jreqs, jkeys, chunk)
    assert [t for t, _ in mine] == [t for t, _ in ref]
    assert [p["keys"] for _, p in mine] == [p["keys"] for _, p in ref]
    assert [[s.label for s in p["specs"]] for _, p in mine] == \
        [[s.label for s in p["specs"]] for _, p in ref]
    assert fleet.task_set_digest(mine) == jfleet.task_set_digest(ref)
    root = str(tmp_path / "cache")
    assert fleet.default_coord_dir(root, mine) == \
        jfleet.default_coord_dir(root, ref)


def _write_coord(mod, root):
    """Every kind of record through one package's Coordinator/LeaseDir."""
    coord = mod.Coordinator(root)
    coord.mark_done("t-done", "w0", 0.25, 1, extra={"divergence": {"a": 0.5}})
    try:
        raise OSError("transient disk")
    except OSError as exc:
        coord.mark_error("t-err", "w1", exc, True)
    coord.synthetic_error("t-died", "w2", "no heartbeat for 9.0s")
    coord.mark_poison("t-poison", {"task": "t-poison", "exc_type":
                                   "ValueError", "attempts": 1,
                                   "why": "deterministic failure"})
    coord.write_metrics({"total": 4, "done": 1, "accounted": 2})
    coord.write_obs({"schema": "repro.obs/1", "counters": {"fleet.done": 1}})
    assert coord.leases.claim("t-lease", "w3", meta={"trace_id": "abc"})
    assert not coord.leases.claim("t-lease", "w4")


def _read_coord(mod, root):
    coord = mod.Coordinator(root)
    err = coord.error_record("t-err")
    return {
        "done": [coord.is_done(t) for t in ("t-done", "t-err")],
        "done_rec": coord.done_record("t-done"),
        "err": {k: err[k] for k in ("task", "owner", "exc_type", "exc",
                                    "retryable")},
        "err_tb": "OSError: transient disk" in err["traceback"],
        "died": coord.error_record("t-died"),
        "has_error": [coord.has_error(t) for t in ("t-err", "t-done")],
        "poison": coord.poison_manifest(),
        "is_poisoned": coord.is_poisoned("t-poison"),
        "metrics": coord.read_metrics(),
        "obs": coord.read_obs(),
        "leases": coord.leases.active(),
        "held": coord.leases.held("t-lease"),
        "owner": {k: v for k, v in coord.leases.owner("t-lease").items()
                  if k != "t_claim"},
        "aged": coord.leases.age("t-lease") >= 0.0,
    }


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_coordination_dir_reads_across_packages(writer, tmp_path):
    root = str(tmp_path / "coord")
    _write_coord(jfleet if writer == "jax" else fleet, root)
    ref = _read_coord(jfleet, root)
    mine = _read_coord(fleet, root)
    assert mine == ref
    assert mine["done"] == [True, False] and mine["err_tb"]
    assert mine["owner"] == {"owner": "w3", "pid": os.getpid(),
                             "trace_id": "abc"}
    # the other package retracts, releases and clears what this one wrote
    other = fleet if writer == "jax" else jfleet
    coord = other.Coordinator(root)
    coord.clear_done("t-done")
    coord.clear_error("t-err")
    coord.leases.release("t-lease")
    reader = jfleet.Coordinator(root) if writer == "jax" \
        else fleet.Coordinator(root)
    assert not reader.is_done("t-done") and not reader.has_error("t-err")
    assert reader.leases.active() == []
    assert LeaseDir(os.path.join(root, "leases")).owner("t-lease") is None


def test_fleet_metrics_export_equals_jax():
    walls = np.random.default_rng(0).lognormal(-2.0, 0.5, size=40)
    counters = dict(total=9, done=7, already_done=2, computed=5, poisoned=1,
                    retried=3, stragglers=1, kills=2, lease_breaks=3,
                    worker_restarts=1, workers_spawned=3, verify_requeues=1,
                    wall_s=12.5, chaos="kill:worker=0,after=1",
                    poison=[{"task": "t", "why": "deterministic failure"}])
    mine, ref = fleet.FleetMetrics(**counters), \
        jfleet.FleetMetrics(**counters)
    for w in walls.tolist():
        mine.chunk_wall.observe(w)
        ref.chunk_wall.observe(w)
    assert mine.accounted == ref.accounted == 8
    assert mine.as_dict() == ref.as_dict()
    assert mine.obs_snapshot() == ref.obs_snapshot()


def _payload_bytes(cache_cls, root, keys):
    store = cache_cls(root)
    out = {}
    for k in keys:
        res = store.get(k)
        assert res is not None, f"missing cache entry {k[:12]}"
        out[k] = (np.asarray(res.fcts, np.float64).tobytes(),
                  np.asarray(res.slowdowns, np.float64).tobytes())
    return out


def _work_in_process(job, tasks, coord_root):
    """One worker over the whole task list, in this process: it returns
    once every task is done (nothing here fails)."""
    fleet.worker_entry(0, coord_root, job, tasks, None, 0.05, 0.01)
    coord = fleet.Coordinator(coord_root)
    assert all(coord.is_done(t) for t, _ in tasks)
    return coord


def test_worker_entry_flowsim_equals_inprocess_and_jax(tmp_path):
    be, specs, reqs, keys = _sweep("port", n=6)
    _, jspecs, jreqs, jkeys = _sweep("jax", n=6)
    cache = str(tmp_path / "fleet")
    job = fleet.sweep_job_for(be, cache)
    assert job.device == "cpu" and job.backend_kwargs == {}
    tasks = fleet.sweep_tasks(specs, reqs, keys, 2)
    coord = _work_in_process(job, tasks, str(tmp_path / "coord"))
    assert {coord.done_record(t)["owner"] for t, _ in tasks} == {"w0"}
    got = _payload_bytes(ResultCache, cache, keys)
    # the port's in-process sweep at the same chunk size
    SweepRunner(be, cache_dir=str(tmp_path / "inline"), chunk_size=2).run(
        specs)
    assert got == _payload_bytes(ResultCache, str(tmp_path / "inline"), keys)
    # JAX's run_chunked under the same keys, and JAX's cache reads the
    # port's fleet entries
    ref = jax_backend("flowsim").run_chunked(jreqs, 2)
    assert jkeys == keys
    assert got == {k: (np.asarray(r.fcts, np.float64).tobytes(),
                       np.asarray(r.slowdowns, np.float64).tobytes())
                   for k, r in zip(jkeys, ref)}
    assert _payload_bytes(JaxCache, cache, keys) == got


def test_worker_entry_flowsim_fast_equals_inprocess(tmp_path):
    be = get_backend("flowsim_fast", device="cpu")
    specs = list(get_suite("smoke16", num_flows=8).limit(5))
    reqs = [s.to_request() for s in specs]
    keys = [result_key(r, be) for r in reqs]
    cache = str(tmp_path / "fleet")
    job = fleet.sweep_job_for(be, cache)
    assert job.device == "cpu" and job.backend_kwargs == {"device": "cpu"}
    tasks = fleet.sweep_tasks(specs, reqs, keys, 2)
    _work_in_process(job, tasks, str(tmp_path / "coord"))
    assert job._backend().fingerprint() == be.fingerprint() \
        == "flowsim_fast_torch-ktorch"
    SweepRunner(be, cache_dir=str(tmp_path / "inline"), chunk_size=2).run(
        specs)
    assert _payload_bytes(ResultCache, cache, keys) == \
        _payload_bytes(ResultCache, str(tmp_path / "inline"), keys)


def test_sweep_job_ships_m4_weights_as_numpy():
    cfg = M4Config(**GATE)
    be = get_backend("m4", params=init_m4(0, cfg), cfg=cfg, device="cpu")
    job = pickle.loads(pickle.dumps(fleet.sweep_job_for(be, "unused")))
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            leaves.append(t)
    walk(job.backend_kwargs["params"])
    assert leaves and all(isinstance(x, np.ndarray) for x in leaves)
    assert job.backend_kwargs["cfg"] == cfg and job.device == "cpu"
    # a worker's rebuilt backend writes the dispatcher's keys
    assert job._backend().fingerprint() == be.fingerprint()
    assert be.fingerprint().startswith("m4_torch-") and \
        be.fingerprint().endswith("-ktorch")


def test_dataset_job_equals_inline_build_and_jax_keys(tmp_path):
    from repro.core.model import M4Config as JaxM4Config
    from repro.train.data import shard_key as jax_shard_key
    cfg = M4Config(**GATE)
    jcfg = JaxM4Config(**GATE)
    specs = list(get_suite("smoke16", num_flows=8).limit(3))
    jspecs = list(jax_suite("smoke16", num_flows=8).limit(3))
    keys = [tdata.shard_key(s, cfg, max_events=40) for s in specs]
    assert keys == [jax_shard_key(s, jcfg, max_events=40) for s in jspecs]
    tasks = fleet.dataset_tasks(specs, keys)
    assert [t for t, _ in tasks] == \
        [t for t, _ in jfleet.dataset_tasks(jspecs, keys)] == keys
    root = str(tmp_path / "fleet")
    job = fleet.DatasetJob(root=root, m4cfg=cfg, max_events=40)
    assert job.device == "cpu"
    _work_in_process(job, tasks, str(tmp_path / "coord"))
    inline = str(tmp_path / "inline")
    _, rep = tdata.build_dataset(specs, cfg, inline, max_events=40)
    assert rep.misses == 3 and rep.fleet is None
    store, ref = tdata.DatasetStore(root), tdata.DatasetStore(inline)
    for k in keys:
        with open(store._path(k), "rb") as a, open(ref._path(k), "rb") as b:
            assert a.read() == b.read()


def _diff_coord(tmp_path):
    """A flowsim_fast fleet stamped against the flowsim oracle, whose
    entries are already in the same cache."""
    cache = str(tmp_path / "cache")
    specs = list(get_suite("smoke16", num_flows=8).limit(4))
    oracle = get_backend("flowsim")
    SweepRunner(oracle, cache_dir=cache, chunk_size=2).run(specs)
    be = get_backend("flowsim_fast", device="cpu")
    reqs = [s.to_request() for s in specs]
    keys = [result_key(r, be) for r in reqs]
    job = fleet.sweep_job_for(be, cache, diff_against=oracle.fingerprint())
    tasks = fleet.sweep_tasks(specs, reqs, keys, 2)
    coord_root = str(tmp_path / "coord")
    _work_in_process(job, tasks, coord_root)
    return cache, coord_root, specs, reqs, keys, oracle


def test_divergence_from_coord_equals_jax(tmp_path):
    cache, coord_root, specs, reqs, keys, oracle = _diff_coord(tmp_path)
    mine, ref = divergence_from_coord(coord_root), jax_divergence(coord_root)
    assert mine == ref
    assert mine["tasks"] == 2 and len(mine["scenarios"]) == len(specs)
    store = ResultCache(cache)
    for spec, req, key in zip(specs, reqs, keys):
        err = flow_rel_err(store.get(key).fcts,
                           store.get(result_key(req, oracle)).fcts)
        assert mine["scenarios"][spec.label] == \
            round(float(err.mean()), 6)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_obs_check_coord_agrees_across_packages(writer, tmp_path,
                                                monkeypatch, capsys):
    spans = str(tmp_path / "spans")
    monkeypatch.setenv(ptrace.TRACE_DIR_ENV, "")
    monkeypatch.delenv(ptrace.TRACE_PARENT_ENV, raising=False)
    coord_root = str(tmp_path / "coord")
    if writer == "port":
        ptrace.configure(spans, proc="test")
        try:
            be, specs, reqs, keys = _sweep("port", n=4)
            job = fleet.sweep_job_for(be, str(tmp_path / "cache"))
            _work_in_process(job, fleet.sweep_tasks(specs, reqs, keys, 2),
                             coord_root)
        finally:
            ptrace.configure(None)
    else:
        jtrace.configure(spans, proc="test")
        try:
            be, specs, reqs, keys = _sweep("jax", n=4)
            job = jfleet.sweep_job_for(be, str(tmp_path / "cache"))
            tasks = jfleet.sweep_tasks(specs, reqs, keys, 2)
            jfleet.worker_entry(0, coord_root, job, tasks, None, 0.05, 0.01)
        finally:
            jtrace.configure(None)
    argv = ["--dir", spans, "--check", "--coord", coord_root]
    assert obs_main(argv) == 0
    assert jax_obs_main(argv) == 0
    assert "2 done tasks stitched" in capsys.readouterr().out
    # a done marker with no trace behind it fails both
    fleet.Coordinator(coord_root).mark_done("f" * 64, "w9", 0.1, 1)
    assert obs_main(argv) == 1
    assert jax_obs_main(argv) == 1
    out = capsys.readouterr().out
    assert out.count("no closed fleet.task root span") == 2


def test_sweeprunner_fleet_needs_a_cache_and_the_cache_path():
    with pytest.raises(ValueError, match="cache_dir"):
        SweepRunner(get_backend("flowsim"), fleet=fleet.FleetConfig())


def test_sweeprunner_fleet_refuses_record_events(tmp_path):
    runner = SweepRunner(get_backend("flowsim"), cache_dir=str(tmp_path),
                         fleet=fleet.FleetConfig())
    with pytest.raises(ValueError, match="record_events"):
        runner.run(get_suite("smoke16", num_flows=8).limit(2),
                   record_events=True)


def test_sweeprunner_fleet_falls_back_inline_without_main(tmp_path,
                                                          monkeypatch):
    """No importable __main__: the misses run in this process on the same
    backend, as JAX's runner does; no fleet metrics."""
    monkeypatch.setattr(tdata, "_pool_usable", lambda: False)
    be = get_backend("flowsim")
    suite = get_suite("smoke16", num_flows=8).limit(4)
    runner = SweepRunner(be, cache_dir=str(tmp_path / "c"), chunk_size=2,
                         fleet=fleet.FleetConfig())
    rep = runner.run(suite)
    assert rep.fleet is None and rep.misses == 4
    assert all(e.result is not None for e in rep.entries)
    assert runner.run(suite).hits == 4


def test_build_dataset_pool_falls_back_inline_without_main(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(tdata, "_pool_usable", lambda: False)
    cfg = M4Config(**GATE)
    specs = list(get_suite("smoke16", num_flows=8).limit(2))
    lines = []
    _, rep = tdata.build_dataset(specs, cfg, str(tmp_path), max_events=20,
                                 workers=2, log=lines.append)
    assert rep.fleet is None and rep.misses == 2
    assert any("building inline" in ln for ln in lines)


def test_fleet_cli_all_cached_exits_clean(tmp_path, capsys):
    """Every scenario already cached: nothing to dispatch, no spawn, an
    all-zero record, exit 0."""
    from repro_torch.fleet.__main__ import main as fleet_main
    cache = str(tmp_path / "cache")
    SweepRunner(get_backend("flowsim_fast", device="cpu"), cache_dir=cache,
                chunk_size=1).run(get_suite("smoke16", num_flows=8).limit(2))
    out = str(tmp_path / "m.json")
    assert fleet_main(["--suite", "smoke16", "--num-flows", "8", "--limit",
                       "2", "--device", "cpu", "--cache-dir", cache,
                       "--expect-clean", "--metrics-out", out]) == 0
    with open(out) as f:
        m = json.load(f)
    assert m["total"] == m["workers_spawned"] == 0
    assert "2 cached / 0 simulated" in capsys.readouterr().out
