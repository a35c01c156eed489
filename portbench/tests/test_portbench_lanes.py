"""Lanes are files found by name: the two flow lanes moved there keep
the parent's pool, requests and comparison numbers bitwise, and a
further lane, traffic mix, configuration and cell added as files to a
copy of the checkout run with no file of the benchmark edited."""
import hashlib
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import gen, lanes, runner, spec
from portbench.tests.conftest import small_cell

ROOT = Path(__file__).resolve().parents[2]
PARENT = json.loads((Path(__file__).parent / "parent_flows.json").read_text())


def pool_digest(pool):
    h = hashlib.sha256()
    for batch in pool:
        for s in batch:
            h.update(json.dumps([s.point, repr(s.net)],
                                sort_keys=True).encode())
            for a in (s.src, s.dst, s.size, s.t_arrival):
                h.update(np.ascontiguousarray(a).tobytes())
            h.update(json.dumps([[int(x) for x in p]
                                 for p in s.paths]).encode())
    return h.hexdigest()


def requests_digest(reqs):
    h = hashlib.sha256()
    for r in reqs:
        h.update(repr((r.topo, r.config, r.flows)).encode())
    return h.hexdigest()


@pytest.mark.parametrize("key", sorted(PARENT))
def test_flow_lanes_keep_the_parents_pool_requests_and_numbers(key):
    """The digests and numbers of `parent_flows.json` were read with the
    harness before lanes were files (`gen.pool`, `lanes.requests`,
    `check.numbers`, `runner._failed`), on the same small cells and the
    same stored answers: the flowSim reference's times, perturbed from
    the seed, one time left out."""
    name, seed = key.split("/")
    seed = int(seed)
    want = PARENT[key]
    cell = small_cell(name, flows=60, batch=3)
    lane = lanes.lane(cell.traffic, cell.config)
    pool = lane.pool(seed)
    assert pool_digest(pool) == pool_digest(
        gen.pool(cell.config, cell.traffic, seed)) == want["pool"]
    assert [requests_digest(lane.inputs(b, "cpu")) for b in pool] == \
        want["requests"]
    fs = lanes.lane(dict(cell.traffic, lane="flowsim_fast"), cell.config)
    refs = {k: fs.reference(b, None, "cpu")[0] for k, b in enumerate(pool)}
    rng = np.random.default_rng(seed)
    outs = []
    for k in sorted(refs):
        got = [r * (1 + rng.normal(0, 1e-6, len(r))) for r in refs[k]]
        if k == 1:
            got[0] = got[0].copy()
            got[0][3] = np.nan
        outs.append((k, got))
    assert lane.numbers(outs, refs) == want["numbers"]
    assert lane.failed(outs, refs) == want["failed"]


ECHO = '''"""A lane of a test: its call echoes the pool batch back, and its
reference does the same."""
import numpy as np

from portbench.harness import lanes


class Lane(lanes.Lane):
    def pool(self, seed):
        rng = np.random.default_rng(seed)
        return [rng.random(self.traffic["batch"])
                for _ in range(self.traffic["pool"])]

    def backend(self, weights, device):
        return "echo"

    def call(self, backend, inputs):
        return inputs.copy(), len(inputs), 1

    def reference(self, batch, weights, device, *, control=False):
        return batch, {"seen": len(batch)}

    def numbers(self, outs, refs):
        return {"echo_gap": max(float(np.abs(a - refs[k]).max())
                                for k, a in outs)}

    def failed(self, outs, refs):
        return 0

    def fields(self, pool):
        return {"items": sum(len(b) for b in pool)}
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_further_lane_runs_from_new_files_alone(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)
    pb = tmp_path / "portbench"
    (pb / "lanes" / "echo.py").write_text(ECHO)
    (pb / "traffic" / "echo-b4.json").write_text(json.dumps(
        {"lane": "echo", "batch": 4, "pool": 2}))
    (pb / "configs" / "echo-cfg.json").write_text(json.dumps(
        {"name": "echo-cfg", "model": {}}))
    (pb / "cells" / "echo-cfg.echo-b4.json").write_text(json.dumps(
        {"limits": {"echo_gap": 0.0}}))
    (pb / "metrics" / "items_seen.py").write_text(
        'def read(run):\n    return float(run.items)\n')
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "echo-cfg", "source": "a test",
                             "file": "portbench/configs/echo-cfg.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "echo-cfg.echo-b4",
                               "config": "echo-cfg", "traffic": "echo-b4",
                               "chips": 1, "why": "a test's cell"})
    cell_list = ["echo-cfg.echo-b4"]
    bench["end_to_end"].insert(0, {"name": "items_per_s.echo",
                                   "unit": "items/s", "better": "higher",
                                   "bound": 0.05, "source": "host_clock",
                                   "workloads": cell_list})
    (pb / "metrics" / "items_per_s.py").write_text(
        'def read(run):\n    c = run.calls\n'
        '    return sum(x.units for x in c) / max(c[-1].end - c[0].start,'
        ' 1e-9)\n')
    bench["per_layer"].append({"name": "items_seen", "unit": "items",
                               "better": "higher", "source": "host_clock",
                               "layer": "echo", "moves": "items_per_s.echo",
                               "workloads": cell_list})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before

    for traced, want in ((False, {"items_per_s.echo", "setup_s"}),
                         (True, {"items_seen"})):
        cell = spec.find_cell(spec.load_benchmark(tmp_path),
                              "echo-cfg.echo-b4", traced, root=tmp_path)
        result, checks = runner.execute(cell, 2 ** 31 + 7, 0.0, traced, 0.0,
                                        log=lambda s: None, device="cpu")
        assert result["correct"] and checks["echo_gap"]["value"] == 0.0
        assert set(result["metrics"]) == want
        passes = 1 + lanes.Lane.traced_passes if traced else 1
        assert result["attempted"] == passes * 2     # one answer a call
    assert result["metrics"]["items_seen"]["value"] == 8.0
