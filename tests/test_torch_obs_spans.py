"""The port's spans inside `run_many`, in both sinks, on the CPU.

- under `torch.profiler`, one `run_many` of each lane (m4, flowsim_fast)
  yields the spans of its layers as the profiler's host records: the
  root `sim.run_many` around `sim.prep`, `sim.upload`, (flowSim)
  `sim.incidence`, `compiled.run` (`compiled.load`, `compiled.replay`
  inside it), `sim.readback` and `sim.results`, in that order;
- with a trace directory, the JSONL file holds the same names and
  parents, with the attributes at each boundary, and
  `python -m repro_torch.obs --check` passes on it;
- flowSim's `sim.upload` carries the incidence as rows of per-flow
  links: its `bytes` at B = 2, N = 64, L = 2000 is within twice
  B·(N·K + L)·4, far below the dense arena's B·N·L·4;
- both sinks at once share one clock: each JSONL span starts within
  2 ms of its profiler record;
- with neither sink on, `span()` is `NULL_SPAN` and opens no profiler
  range; a `Tracer.start()` span opens none either (it may cross
  threads).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores

from repro_torch.core import compiled  # noqa: E402
from repro_torch.core import flowsim_fast as tff  # noqa: E402
from repro_torch.core.model import M4Config, init_m4  # noqa: E402
from repro_torch.obs import __main__ as port_cli  # noqa: E402
from repro_torch.obs import trace as ttr  # noqa: E402
from repro_torch.net import FatTree, Flow  # noqa: E402
from repro_torch.scenarios import ScenarioSpec  # noqa: E402
from repro_torch.sim import get_backend  # noqa: E402

GATE = dict(hidden=16, gnn_dim=16, mlp_hidden=16, gnn_layers=2,
            snap_flows=16, snap_links=32)
LANES = ("m4", "flowsim_fast")
# (name, parent) of each span of one warm call, in order of start
TREE = {
    "m4": [("sim.run_many", None), ("sim.prep", "sim.run_many"),
           ("sim.upload", "sim.run_many"), ("compiled.run", "sim.run_many"),
           ("compiled.load", "compiled.run"),
           ("compiled.replay", "compiled.run"),
           ("sim.readback", "sim.run_many"), ("sim.results", "sim.run_many")],
    "flowsim_fast": [
        ("sim.run_many", None), ("sim.prep", "sim.run_many"),
        ("sim.upload", "sim.run_many"), ("sim.incidence", "sim.run_many"),
        ("compiled.run", "sim.run_many"), ("compiled.load", "compiled.run"),
        ("compiled.replay", "compiled.run"),
        ("sim.readback", "sim.run_many"), ("sim.results", "sim.run_many")],
}
NAMES = {n for tree in TREE.values() for n, _ in tree}


@pytest.fixture(scope="module")
def backends():
    cfg = M4Config(**GATE)
    return {"m4": get_backend("m4", params=init_m4(0, cfg), cfg=cfg,
                              device="cpu"),
            "flowsim_fast": get_backend("flowsim_fast", device="cpu")}


@pytest.fixture(scope="module")
def reqs():
    return [ScenarioSpec(topo="ft-4x2x2", num_flows=10, seed=s,
                         max_load=0.4).to_request() for s in (1, 2)]


@pytest.fixture
def tracer(monkeypatch):
    """The process's tracer, with no trace directory (restored after)."""
    t = ttr.Tracer(None)
    monkeypatch.setattr(ttr, "_GLOBAL", t)
    return t


def _profiled(fn):
    """fn() under `torch.profiler`; the port's span records, by start."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    recs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name() in NAMES or e.name() == "outside"]
    return sorted(recs, key=lambda r: r[1])


def _parent(recs, i):
    """The innermost record that holds record i."""
    _, s, e = recs[i]
    best = None
    for j, (n, s2, e2) in enumerate(recs):
        if j != i and s2 <= s and e <= e2 and (
                best is None or e2 - s2 < best[2] - best[1]):
            best = recs[j]
    return None if best is None else best[0]


@pytest.mark.parametrize("lane", LANES)
def test_profiler_records_the_spans_nested(lane, backends, reqs, tracer):
    backends[lane].run_many(reqs)                  # build the program
    recs = _profiled(lambda: backends[lane].run_many(reqs))
    got = [(n, _parent(recs, i)) for i, (n, _, _) in enumerate(recs)]
    assert got == TREE[lane]
    assert tracer.current() is None                # every span closed


@pytest.mark.parametrize("lane", LANES)
def test_jsonl_spans_match_and_pass_the_check(lane, backends, reqs,
                                              monkeypatch, tmp_path):
    monkeypatch.setattr(ttr, "_GLOBAL", ttr.Tracer(str(tmp_path)))
    compiled.clear_compiled()
    backends[lane].run_many(reqs)                  # builds: new=True
    backends[lane].run_many(reqs)
    ttr.get_tracer().close()
    spans = ttr.read_spans(str(tmp_path))
    traces = list(ttr.spans_by_trace(spans).values())
    assert len(traces) == 2
    for recs, new in zip(sorted(traces, key=lambda r: r[0]["t_start"]),
                         (True, False)):
        by_id = {r["span_id"]: r["name"] for r in recs}
        assert [(r["name"], by_id.get(r["parent_id"])) for r in recs] \
            == TREE[lane]
        attrs = {r["name"]: r["attrs"] for r in recs}
        root = attrs["sim.run_many"]
        assert root["lane"] == lane and root["scenarios"] == 2
        assert root["flows"] == sum(r.num_flows for r in reqs)
        assert root["N"] == max(r.num_flows for r in reqs)
        assert root["L"] == reqs[0].topo.num_links
        assert ("K" in root) == (lane == "m4")
        assert attrs["sim.upload"]["bytes"] > 0
        assert attrs["sim.upload"]["pinned"] is False
        run = attrs["compiled.run"]
        assert run["device"] == "cpu" and run["new"] is new
        assert run["entry"] == ("open_loop_batched" if lane == "m4"
                                else "event_scan_batched")
        assert attrs["compiled.replay"]["replays"] == 2 * root["N"]
        if lane == "flowsim_fast":
            assert attrs["sim.incidence"]["width"] is None  # dense, CPU
    assert port_cli.main(["--dir", str(tmp_path), "--check"]) == 0


def test_flowsim_upload_bytes_are_the_rows_not_the_dense_arena(
        monkeypatch, tmp_path):
    """The counter of the incidence's form: what `sim.upload` copies for
    B = 2 scenarios of N = 64 flows on L = 2000 links. The event loop is
    stubbed (it does not touch the upload)."""
    topo = FatTree(num_racks=10, hosts_per_rack=90, num_spines=10)
    B, N, L = 2, 64, topo.num_links
    assert L == 2000
    rng = np.random.default_rng(0)
    scenarios = []
    for _ in range(B):
        src, dst = rng.choice(topo.num_hosts, (2, N))
        scenarios.append((topo, [
            Flow(fid=i, src=int(s), dst=int(d), size=1000,
                 t_arrival=1e-6 * i, path=topo.path(int(s), int(d), i))
            for i, (s, d) in enumerate(zip(src, dst))]))
    K = max(len(f.path) for _, flows in scenarios for f in flows)
    monkeypatch.setattr(ttr, "_GLOBAL", ttr.Tracer(str(tmp_path)))
    monkeypatch.setattr(tff, "_event_scan_core", lambda links, *a, **k:
                        torch.ones(links.shape[:2]))
    tff.run_flowsim_fast_batch(scenarios, device="cpu")
    ttr.get_tracer().close()
    (upload,) = [r["attrs"] for r in ttr.read_spans(str(tmp_path))
                 if r["name"] == "sim.upload"]
    assert upload["bytes"] > 0 and upload["pinned"] is False
    assert upload["bytes"] <= 2 * B * (N * K + L) * 4 < B * N * L * 4 // 20


@pytest.mark.parametrize("lane", LANES)
def test_both_sinks_share_one_clock(lane, backends, reqs, monkeypatch,
                                    tmp_path):
    monkeypatch.setattr(ttr, "_GLOBAL", ttr.Tracer(str(tmp_path)))
    backends[lane].run_many(reqs)
    ttr.get_tracer().close()
    os.remove(next(p for p in tmp_path.iterdir()))
    recs = _profiled(lambda: backends[lane].run_many(reqs))
    ttr.get_tracer().close()
    spans = sorted(ttr.read_spans(str(tmp_path)),
                   key=lambda r: r["t_start"])
    assert [r["name"] for r in spans] == [n for n, _, _ in recs]
    for rec, (_, s, e) in zip(spans, recs):
        assert abs(rec["t_start"] * 1e9 - s) < 2e6, rec["name"]
        assert abs(rec["t_end"] * 1e9 - e) < 2e6, rec["name"]


def test_neither_sink_on_gives_the_null_span(backends, reqs, tracer,
                                             monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a profiler range was opened")
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert not ttr.profiling()
    assert tracer.span("sim.run_many") is ttr.NULL_SPAN
    for lane in LANES:
        backends[lane].run_many(reqs)
    assert tracer.current() is None


def test_start_span_opens_no_profiler_range(tmp_path):
    t = ttr.Tracer(str(tmp_path))

    def cross_thread():
        t.start("outside").end()
        t.emit_span("outside", t.start("outside"), 0.0, 1.0)
    assert _profiled(cross_thread) == []
    assert [r["name"] for r in ttr.read_spans(str(tmp_path))] == [
        "outside", "outside"]
    # a pushed span does open one, the JSONL sink off
    recs = _profiled(lambda: ttr.Tracer(None).span("outside").end())
    assert [n for n, _, _ in recs] == ["outside"]
