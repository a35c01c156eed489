"""The harness is driven by data: a cell, a configuration, a traffic mix
or a metric added as files and entries is found by name and reported,
with no file of the harness edited; and the result's line has the keys
of the benchmark's contract, the numbers compared last."""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import lanes, runner, spec
from portbench.harness.runner import Call, Run
from portbench.harness.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
NAME = r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$"


@pytest.fixture
def checkout(tmp_path):
    """A copy of the benchmark's files, as a checkout holds them."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_new_cell_config_traffic_and_metric_are_found_by_name(checkout):
    pb = checkout / "portbench"
    cfg = json.loads((pb / "configs" / "ft8-table2.json").read_text())
    cfg["name"] = "ft4-tiny"
    (pb / "configs" / "ft4-tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "m4-b8.json").read_text())
    (pb / "traffic" / "m4-b2.json").write_text(json.dumps(
        dict(mix, batch=2)))
    (pb / "cells" / "ft4-tiny.m4-b2.json").write_text(json.dumps(
        {"limits": {"missing": 0}}))
    (pb / "metrics" / "calls_seen.py").write_text(
        'def read(run):\n    return float(len(run.calls))\n')
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="ft4-tiny",
                                 file="portbench/configs/ft4-tiny.json"))
    bench["workloads"].append({"name": "ft4-tiny.m4-b2",
                               "config": "ft4-tiny", "traffic": "m4-b2",
                               "chips": 1, "why": "a test's cell"})
    bench["per_layer"].append({"name": "calls_seen", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "flows_per_s.m4",
                               "workloads": ["ft4-tiny.m4-b2"]})
    # a split metric: the same reader under a name of the new cell's own
    bench["end_to_end"].append({"name": "flows_per_s.tiny",
                                "unit": "flows/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["ft4-tiny.m4-b2"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.find_cell(spec.load_benchmark(checkout), "ft4-tiny.m4-b2",
                          True, root=checkout)
    assert cell.config["name"] == "ft4-tiny"
    assert cell.traffic["batch"] == 2
    assert cell.limits == {"missing": 0}
    names = [m["name"] for m in cell.metrics]
    assert "calls_seen" in names and "m4_step_us" not in names
    mods = spec.readers(cell.metrics, checkout)
    run = _fake_run(cell)
    assert mods["calls_seen"].read(run) == 2.0
    e2e = spec.find_cell(spec.load_benchmark(checkout), "ft4-tiny.m4-b2",
                         False, root=checkout)
    assert sorted(m["name"] for m in e2e.metrics) == ["flows_per_s.tiny",
                                                      "setup_s"]
    assert spec.readers(e2e.metrics, checkout)["flows_per_s.tiny"].read(
        run) == pytest.approx(32000 / 2.0)
    # an existing cell does not see the new metrics
    for traced in (False, True):
        old = spec.find_cell(spec.load_benchmark(checkout),
                             "ft8-table2.m4-b8", traced, root=checkout)
        names = [m["name"] for m in old.metrics]
        assert "calls_seen" not in names and "flows_per_s.tiny" not in names


def _fake_run(cell, traced=True):
    """A measured run, mocked: two calls and a trace of four device
    operations."""
    calls = [Call(0, 0.0, 1.0, 16000, 8), Call(1, 1.2, 2.0, 16000, 8)]
    tr = Trace(window=(0, 2_000_000_000),
               calls=[(0, 1_000_000_000), (1_200_000_000, 2_000_000_000)],
               dev_names=["gru_pair_kernel", "waterfill_event_kernel",
                          "bipartite_rounds_kernel"],
               dev_op=np.array([0, 1, 2, 1]),
               dev_start=np.array(
                   [100_000_000, 500_000_000, 1_300_000_000,
                    1_500_000_000]),
               dev_end=np.array(
                   [400_000_000, 900_000_000, 1_400_000_000,
                    1_900_000_000]),
               host=[(0, 2_000_000_000, "portbench.run_many")])
    return Run(cell=cell, setup_s=12.5, calls=calls, batch=8,
               num_flows=200, num_links={0: 128, 1: 128},
               nnz={0: [8000] * 8, 1: [8000] * 8}, steps=64, prompt=1020,
               max_len=1084,
               counts={k: {"live_edges": np.full(8, 1e5),
                           "rounds": np.ones((400, 8))}
                       for k in (0, 1)},
               trace=tr if traced else None,
               traced_calls=calls if traced else [])


WORKLOADS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_metric_reads_a_mocked_run(workload, traced):
    """A mocked run of each lane, with the fields of every lane."""
    cell = spec.find_cell(spec.load_benchmark(), workload, traced)
    run = _fake_run(cell, traced)
    for name, mod in spec.readers(cell.metrics).items():
        v = mod.read(run)
        assert isinstance(v, float) and v >= 0, name
        if name.endswith("_pct"):
            assert v <= 100.0, name
    if traced:
        tr = run.trace
        assert tr.busy_s() == pytest.approx(1.2)
        assert spec.reader("device_idle_pct.m4").read(run) == \
            pytest.approx(40.0)
        # each call's start to its first device operation: 0 to 0.1 s and
        # 1.2 to 1.3 s
        assert spec.reader("host_gap_ms.flowsim").read(run) == \
            pytest.approx(100.0)
        # 1.2 s of device operations over 2 calls of 64 steps
        assert spec.reader("lm_step_us").read(run) == \
            pytest.approx(1.2e6 / 128)


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_has_the_contracts_keys_checks_last(traced):
    result = {"correct": True, "attempted": 16, "failed": 0,
              "metrics": {"flows_per_s": {"value": 1.5, "unit": "flows/s"}},
              "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                         "count": 1, "memory_peak_bytes": 1}}
    if traced:
        result["breakdown"] = {"device_ops": [], "idle_gaps": []}
    checks = {"missing": {"value": 0.0, "limit": 0, "ok": True}}
    line = json.loads(runner.line(result, checks))
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == want + (["breakdown"] if traced else []) \
        + ["checks"]
    assert line["checks"] == {"missing": {"value": 0.0, "limit": 0}}


def test_benchmark_json_keeps_to_the_contract():
    import re
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert re.match(NAME, c["name"]) and len(c["source"]) <= 200
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert re.match(NAME, w["name"]) and len(w["why"]) <= 200
        assert (ROOT / "portbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
        assert (ROOT / "portbench" / "cells" / f"{w['name']}.json").is_file()
    names = set()
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert re.match(NAME, m["name"]) and m["name"] not in names
            names.add(m["name"])
            assert callable(spec.reader(m["name"]).read)
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one, and what a per-layer metric moves is reported in
    # each of its cells
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"]
               if spec.applies(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in bench["per_layer"] if spec.applies(m, w["name"])]
        assert layer
        for m in layer:
            assert m["moves"] in e2e, (m["name"], w["name"])


class _Event:
    """A profiler record as `torch.profiler` hands it over."""

    def __init__(self, name, device, start, dur, annotation=False):
        self._v = (name, device, start, dur, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def test_trace_keeps_device_operations_and_drops_span_ranges():
    import torch
    from portbench.harness import trace
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [
        _Event(trace.CALL_SPAN, cpu, 0, 1000, True),
        _Event(trace.CALL_SPAN, cuda, 200, 700, True),   # the span's range
        _Event("aten::copy_", cpu, 150, 100),
        _Event("Memcpy HtoD (Pageable -> Device)", cuda, 200, 100),
        _Event("gru_pair_kernel", cuda, 400, 300),
        _Event("gru_pair_kernel", cuda, 800, 100),
    ]
    tr = trace.reduce(events, torch)
    assert tr.calls == [(0, 1000)] and tr.window == (0, 1000)
    assert tr.busy_s() == pytest.approx(500e-9)
    assert tr.op_seconds(("gru_pair_kernel",)) == pytest.approx(400e-9)
    assert tr.by_name()[0] == ("gru_pair_kernel", pytest.approx(400e-9))
    assert tr.host_label(175).endswith("aten::copy_")
    assert "outside torch operations" in tr.host_label(350)


def _command(cwd, workload="ft8-table2.m4-b8"):
    import subprocess
    import sys
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 1), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_without_the_port_beside_it_fails_and_prints_nothing(checkout):
    out = _command(checkout)
    assert out.returncode != 0 and out.stdout == ""


def test_run_without_a_card_fails_and_prints_nothing():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    out = _command(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_traced_run_profiles_the_passes_after_the_first():
    """A traced run on the CPU's plain paths: the window has the first
    pass and `Lane.traced_passes` more, the calls read as traced are those of
    the profiled passes, the profiler's cost is logged against the
    untraced calls, and the window's device metrics read nothing where
    no device operation ran."""
    from portbench.tests.conftest import small_cell
    cell = small_cell("meta-fabric.flowsim-b8", trace=True, flows=30,
                      batch=2)
    logs = []
    result, checks = runner.execute(cell, 2 ** 31 + 5, 0.0, True, 0.0,
                                    log=logs.append, device="cpu")
    P = cell.traffic["pool"]
    assert result["correct"], checks
    assert result["attempted"] == (1 + lanes.Lane.traced_passes) * P * 2
    cost = [s for s in logs if s.startswith("profiler cost:")]
    assert len(cost) == 1 and all(f"batch {k}: traced" in cost[0]
                                  for k in range(P))
    assert "flowsim_step_us" not in result["metrics"]
    assert result["device"]["platform"] == "cpu"
