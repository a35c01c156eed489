"""What a run is made of, found by name from `BENCHMARK.json`: the cell,
its configuration's file, its traffic mix's file, the reader of each of
its metrics, and the limits of its comparison.

    portbench/configs/<config>.json     sizes, network, parameter space
    portbench/traffic/<mix>.json        lane, batch, flows, pool, points
    portbench/lanes/<lane>.py           the lane's path (`lanes.Lane`)
    portbench/metrics/<reader>.py       read(run), the metric's reader
    portbench/cells/<cell>.json         the comparison's limits

A metric's reader is named by the metric's name up to its first dot:
`flows_per_s.m4` and `flows_per_s.flowsim` both read with
`flows_per_s.py`, in the cells that each lists. Its unit, layer and
source are the metric's entry in `BENCHMARK.json`, and nowhere else.
A later change adds a cell, a configuration, a lane or a metric by
adding such files and entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]        # the checkout


@dataclass
class Cell:
    name: str
    entry: dict          # the cell's entry of `workloads`
    config: dict         # the configuration's file
    traffic: dict        # the traffic mix's file
    limits: dict         # number -> limit, from cells/<cell>.json
    metrics: List[dict]  # the metric entries this run reports, in order
    root: Path = ROOT    # the checkout its files were read from


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, trace: bool,
              root: Path = ROOT) -> Cell:
    """The cell `name` of `bench`, with its files read; `trace` picks
    the per-layer metrics, else the end-to-end ones."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r}; the benchmark has "
                       f"{sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[entry["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / "portbench" / "traffic" / f"{entry['traffic']}.json") \
            as f:
        traffic = json.load(f)
    with open(root / "portbench" / "cells" / f"{name}.json") as f:
        limits = json.load(f)["limits"]
    kind = "per_layer" if trace else "end_to_end"
    metrics = [m for m in bench[kind] if applies(m, name)]
    return Cell(name=name, entry=entry, config=config, traffic=traffic,
                limits=limits, metrics=metrics, root=root)


def load(path: Path, name: str):
    """The module of the file `path`, under the name `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT):
    """The reader of metric `name`: portbench/metrics/<base>.py, where
    <base> is the name up to its first dot."""
    base = name.split(".")[0]
    return load(root / "portbench" / "metrics" / f"{base}.py",
                f"portbench.metrics.{base}")


def readers(metrics: List[dict], root: Path = ROOT) -> Dict[str, object]:
    return {m["name"]: reader(m["name"], root) for m in metrics}
