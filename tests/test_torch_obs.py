"""The port's obs layer against the JAX package's `repro.obs`, on the CPU.

- the same calls on both registries give equal snapshots (the process
  name aside), with descriptions and labelled names;
- histogram quantiles, `hist_quantiles` and `merge_snapshots` of values
  drawn from a numpy seed equal JAX's bitwise;
- `to_prometheus` text is byte-equal to JAX's, and each package's strict
  parser reads both texts alike;
- span files the port writes pass `python -m repro.obs --check`, and
  JAX's pass `python -m repro_torch.obs --check`; a bad nesting fails
  both;
- series JSONL written by either package is read by the other bitwise,
  torn tail included;
- `python -m repro_torch.obs --merge ... --prom` prints what JAX's does;
- the sweep runner counts its cache hits and misses and its
  `sweep.simulate` phase; `fit` counts its steps, the plain dispatch and
  its programs (`train.compiles`, `train.compile_wall_s`) as JAX's `fit`
  counts its steps and compiles; the port's `phase` records what JAX's
  records.
"""
import contextlib
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
pytest.importorskip("jax")

from repro.obs import __main__ as jax_cli  # noqa: E402
from repro.obs import export as jexp  # noqa: E402
from repro.obs import registry as jreg  # noqa: E402
from repro.obs import timeseries as jts  # noqa: E402
from repro.obs import trace as jtr  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import __main__ as port_cli  # noqa: E402
from repro_torch.obs import export as texp  # noqa: E402
from repro_torch.obs import registry as treg  # noqa: E402
from repro_torch.obs import timeseries as tts  # noqa: E402
from repro_torch.obs import trace as ttr  # noqa: E402


def _drive(reg, seed=0):
    """One fixed sequence of registry calls, values from a numpy seed."""
    rng = np.random.default_rng(seed)
    reg.inc("sweep.runs")
    reg.inc(reg_labeled(reg, "sweep.cache_hits", backend="m4"), 3)
    reg.inc(reg_labeled(reg, "sweep.cache_hits", backend="packet"), 0)
    reg.counter("train.steps", desc="optimizer updates").inc(7)
    reg.set_gauge("phase.x.live_bytes", 1234)
    reg.set_gauge(reg_labeled(reg, "diff.mean_rel_err", backend="m4",
                              oracle="packet"), 0.1234567)
    reg.describe("diff.mean_rel_err", "pooled\nerror")
    for v in rng.lognormal(-8, 3, 500):
        reg.observe("train.step_wall_s", float(v))
    for v in np.concatenate([rng.uniform(0, 1e-9, 5), [0.0, -1.0, 1e12]]):
        reg.observe(reg_labeled(reg, "probe.flow_rate", backend="m4"),
                    float(v))


def reg_labeled(reg, name, **kw):
    mod = treg if isinstance(reg, treg.MetricsRegistry) else jreg
    return mod.labeled(name, **kw)


@pytest.fixture()
def snaps():
    t, j = treg.MetricsRegistry("p"), jreg.MetricsRegistry("p")
    _drive(t)
    _drive(j)
    return t.snapshot(), j.snapshot()


def test_registry_snapshots_equal_jax(snaps):
    got, want = snaps
    assert got == want
    assert got["schema"] == treg.SCHEMA == jreg.SCHEMA
    assert treg.split_labels('a{x="1",y="b"}') == \
        jreg.split_labels('a{x="1",y="b"}')
    assert treg.get_registry() is treg.get_registry()
    assert obs.get_registry() is treg.get_registry()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_quantiles_and_merges_equal_jax_bitwise(seed):
    rng = np.random.default_rng(seed)
    parts = [rng.lognormal(rng.uniform(-10, 0), 2, rng.integers(1, 300))
             for _ in range(4)]
    tsnaps, jsnaps = [], []
    for i, vals in enumerate(parts):
        t, j = treg.MetricsRegistry(f"w{i}"), jreg.MetricsRegistry(f"w{i}")
        for v in vals:
            t.observe("h", float(v))
            j.observe("h", float(v))
        t.inc("c", i)
        j.inc("c", i)
        th, jh = t.histogram("h"), j.histogram("h")
        for q in (0.0, 0.1, 0.5, 0.9, 0.99, 0.999, 1.0):
            assert th.quantile(q) == jh.quantile(q)
        assert th.mean == jh.mean
        tsnaps.append(t.snapshot())
        jsnaps.append(j.snapshot())
    merged = treg.merge_snapshots(tsnaps)
    assert merged == jreg.merge_snapshots(jsnaps)
    # a port snapshot merges with JAX's, in either package
    mixed = tsnaps[:2] + jsnaps[2:]
    assert treg.merge_snapshots(mixed) == jreg.merge_snapshots(mixed)
    assert treg.hist_quantiles(merged["histograms"]["h"]) == \
        jreg.hist_quantiles(merged["histograms"]["h"])


def test_prometheus_text_byte_equal_and_parses_in_both(snaps):
    got, want = snaps
    for kw in ({}, {"prefix": "m4", "extra_labels": {"proc": "a"}}):
        text = texp.to_prometheus(got, **kw)
        assert text == jexp.to_prometheus(want, **kw)
        for parse in (texp.parse_prometheus, jexp.parse_prometheus):
            assert parse(text, meta=True) == \
                jexp.parse_prometheus(text, meta=True)
    parsed = texp.parse_prometheus(texp.to_prometheus(got))
    assert texp.lookup(parsed, "repro_train_steps_total") == 7
    assert texp.lookup(parsed, "repro_sweep_cache_hits_total",
                       backend="m4") == 3
    for bad in ("x y", "# TYPE x nope", 'x{a=1} 2', "x 1\nx 2"):
        with pytest.raises(ValueError):
            texp.parse_prometheus(bad)
        with pytest.raises(ValueError):
            jexp.parse_prometheus(bad)


def _spans(mod, directory, proc):
    """A root span with two sequential children and a grandchild."""
    tr = mod.Tracer(directory, proc=proc)
    with tr.span("sweep", attrs={"n": 2}):
        with tr.span("phase:sweep.simulate"):
            with tr.span("inner"):
                pass
        with tr.span("late"):
            pass
    tr.close()


def _misnest(good, bad):
    """A copy of `good`'s span files whose last child outlives its root."""
    os.makedirs(bad)
    for name in os.listdir(good):
        recs = [json.loads(ln) for ln in open(os.path.join(good, name))]
        late = next(r for r in recs if r["name"] == "late")
        late["t_end"] += 1.0
        with open(os.path.join(bad, name), "w") as fh:
            fh.write("".join(json.dumps(r) + "\n" for r in recs))


def _check(cli, directory):
    with contextlib.redirect_stdout(io.StringIO()):
        return cli.main(["--dir", directory, "--check"])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_span_files_pass_either_check(tmp_path, writer):
    good, bad = str(tmp_path / "good"), str(tmp_path / "bad")
    _spans(ttr if writer == "port" else jtr, good, proc=writer)
    _misnest(good, bad)
    assert _check(port_cli, good) == 0 and _check(jax_cli, good) == 0
    assert _check(port_cli, bad) == 1 and _check(jax_cli, bad) == 1
    spans = ttr.read_spans(good)
    assert spans == jtr.read_spans(good)
    assert {r["name"] for r in spans} == {"sweep", "phase:sweep.simulate",
                                          "inner", "late"}
    assert ttr.spans_by_trace(spans) == jtr.spans_by_trace(spans)
    assert ttr.task_trace_id("t1") == jtr.task_trace_id("t1")
    assert ttr.Tracer(None).span("x") is ttr.NULL_SPAN


def _series(seed, S=6, N=5, L=4):
    rng = np.random.default_rng(seed)
    return {"schema": tts.SCHEMA_TS, "stride": 3, "max_samples": 8,
            "t": np.cumsum(rng.uniform(0, 1e-3, S)),
            "ev": np.arange(S, dtype=np.int64) * 3,
            "channels": {"link_active": rng.integers(0, 9, (S, L)) * 1.0,
                         "flow_remaining": rng.lognormal(8, 2, (S, N))},
            "meta": {"backend": "m4", "units": {"link_active": "flows"}}}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_series_jsonl_cross_read(tmp_path, writer):
    s = _series(3)
    path = str(tmp_path / "a.probes.jsonl")
    (tts if writer == "port" else jts).write_series_jsonl(s, path)
    got, want = tts.read_series_jsonl(path), jts.read_series_jsonl(path)
    for series in (got, want):
        np.testing.assert_array_equal(series["t"], s["t"])
        np.testing.assert_array_equal(series["ev"], s["ev"])
        for ch, v in s["channels"].items():
            np.testing.assert_array_equal(series["channels"][ch], v)
        assert series["meta"] == s["meta"]
    assert tts.validate_series_file(path) == jts.validate_series_file(path)
    assert tts.validate_series_file(path) == []
    # a torn last line: both read the samples before it
    with open(path, "a") as fh:
        fh.write('{"ev": 99, "t": 1.0, "link_ac')
    assert len(tts.read_series_jsonl(path)["t"]) == 6 == \
        len(jts.read_series_jsonl(path)["t"])
    assert tts.summarize_series(s) == jts.summarize_series(s)
    b = _series(4)
    assert tts.series_distance(s, b) == jts.series_distance(s, b)
    bad = dict(s, ev=s["ev"][::-1].copy())
    assert tts.validate_series(bad) == jts.validate_series(bad) != []


def test_observe_series_matches_jax():
    s = _series(5)
    t, j = treg.MetricsRegistry("p"), jreg.MetricsRegistry("p")
    tts.observe_series(s, t, scenario="x")
    jts.observe_series(s, j, scenario="x")
    assert t.snapshot() == j.snapshot()


def test_merge_prom_cli_matches_jax(tmp_path, snaps):
    got, want = snaps
    a = tmp_path / "a.json"
    b = tmp_path / "b.json"
    a.write_text(json.dumps(got))
    # a report carrying its snapshot under "obs" is accepted too
    b.write_text(json.dumps({"train": {}, "obs": want}))
    out = {}
    for name, cli in (("port", port_cli), ("jax", jax_cli)):
        for prom in ([], ["--prom"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert cli.main(["--merge", str(a), str(b), *prom]) == 0
            out[name, bool(prom)] = buf.getvalue()
    assert out["port", True] == out["jax", True]
    assert out["port", False] == out["jax", False]
    assert "repro_train_steps_total 14" in out["port", True]


def _counters():
    return dict(obs.get_registry().snapshot()["counters"])


def test_sweep_runner_records_its_counters_and_phase(tmp_path,
                                                     monkeypatch):
    from repro_torch.scenarios import SweepRunner, get_suite
    from repro_torch.sim import get_backend
    suite = get_suite("smoke16", num_flows=8).limit(3)
    runner = SweepRunner(get_backend("flowsim"), cache_dir=str(tmp_path),
                         chunk_size=2)
    before = _counters()
    # configure exports the trace dir to the environment: undone at exit
    monkeypatch.setenv(ttr.TRACE_DIR_ENV, "")
    obs.configure(str(tmp_path / "spans"), proc="sweep")
    try:
        first = runner.run(suite)
        again = runner.run(suite)
    finally:
        obs.configure(None)
    after = _counters()

    def delta(name):
        return after.get(name, 0) - before.get(name, 0)
    assert (first.misses, again.hits) == (3, 3)
    assert delta('sweep.cache_hits{backend="flowsim"}') == 3
    assert delta('sweep.cache_misses{backend="flowsim"}') == 3
    assert delta("phase.sweep.simulate.calls") == 1
    snap = obs.get_registry().snapshot()
    assert snap["histograms"]["phase.sweep.simulate.wall_s"]["count"] >= 1
    assert first.simulate_s > 0 and again.simulate_s == 0.0
    spans = obs.read_spans(str(tmp_path / "spans"))
    assert [s["name"] for s in spans] == ["phase:sweep.simulate"]
    assert spans[0]["attrs"]["backend"] == "flowsim"
    assert _check(port_cli, str(tmp_path / "spans")) == 0


def test_phase_records_as_jax():
    from repro.obs.jaxprof import phase as jphase
    t, j = treg.MetricsRegistry("p"), jreg.MetricsRegistry("p")
    with obs.phase("x", registry=t) as st:
        pass
    with jphase("x", registry=j):
        pass
    ts, js = t.snapshot(), j.snapshot()
    assert ts["counters"] == js["counters"] == {"phase.x.calls": 1}
    assert set(ts["histograms"]) == set(js["histograms"])
    assert set(ts["gauges"]) == set(js["gauges"])
    assert st.compiles == 0 and st.wall_s >= 0
    # the CPU-only process has no CUDA memory to report
    assert ts["gauges"]["phase.x.live_bytes"] == obs.live_array_bytes()


def test_fit_counts_steps_and_the_plain_dispatch():
    from repro.core.events import EventBatch as JaxEventBatch
    from repro.core.model import M4Config as JaxM4Config
    from repro.train.loop import TrainConfig as JaxTrainConfig
    from repro.train.loop import fit as jax_fit
    from repro_torch.core.events import build_event_batch
    from repro_torch.core.model import M4Config
    from repro_torch.data.traffic import sample_scenario
    from repro_torch.net.packetsim import PacketSim
    from repro_torch.train.loop import TrainConfig, fit
    widths = dict(hidden=8, gnn_dim=8, mlp_hidden=8, gnn_layers=1,
                  snap_flows=8, snap_links=16)
    cfg = M4Config(**widths)
    batches = []
    for seed in (1, 2):
        sc = sample_scenario(seed, num_flows=6)
        trace = PacketSim(sc.topo, sc.config).run(sc.generate())
        batches.append(build_event_batch(trace, cfg))
    kw = dict(epochs=2, bucket_size=1, seed=0)
    jr = jreg.get_registry()
    jbefore = dict(jr.snapshot()["counters"])
    jax_fit([JaxEventBatch.from_arrays(b.to_arrays()) for b in batches],
            JaxM4Config(**widths), JaxTrainConfig(**kw), log=lambda *_: None)
    jafter = jr.snapshot()
    before = _counters()
    fit(batches, cfg, TrainConfig(**kw), device="cpu", log=lambda *_: None)
    after = _counters()
    assert after.get("train.steps", 0) - before.get("train.steps", 0) == 4
    key = 'kernels.dispatch{mode="plain"}'
    assert after.get(key, 0) - before.get(key, 0) == 4
    # one program per bucket shape, in the first epoch, as JAX compiles
    jcompiles = jafter["counters"]["train.compiles"] \
        - jbefore.get("train.compiles", 0)
    assert jcompiles == len({b.footprint for b in batches}) == 2
    assert after["train.compiles"] - before.get("train.compiles", 0) \
        == jcompiles
    hists = obs.get_registry().snapshot()["histograms"]
    for name in ("train.step_wall_s", "train.compile_wall_s"):
        assert name in hists and name in jafter["histograms"]
