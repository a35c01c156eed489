"""Named scenario suites — the sweeps behind the paper's tables + beyond.

A copy of `repro.scenarios.suites`: one suite name builds the same specs
in both packages. A suite is a factory `(**knobs) -> Sweep` registered
under a string name, so tests and the CLI (`python -m
repro_torch.scenarios <suite>`) share one definition of each
experiment's scenario set:

    table1_paper        Table 1's three flowSim-vs-ns3 scenarios (§5.2)
    table3_empirical    Table 3's held-out Meta workloads (§5.2)
    table4_scaling      Table 4's topology-size scaling rows (§5.3)
    table2_train_space  the paper's training distribution: random samples
                        of the full Table-2 space (§5.1)
    table2_grid         grid over Table-2's discrete axes (oversub x CC x
                        size dist x burstiness)
    beyond_paper        incast / permutation / all_to_all / mixed-CDF
                        workloads the paper does not cover
    smoke16             16 shape-diverse CPU-sized scenarios (four
                        topologies, four workload families)
    divergence_worst    the worst m4-vs-oracle scenarios of a divergence
                        report JSON (`worst_specs`; training
                        oversampling)
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List

from .spec import ScenarioSpec, Sweep, spec_from_dict

SUITES: Dict[str, Callable[..., Sweep]] = {}


def register_suite(name: str):
    """Decorator: register a `(**knobs) -> Sweep` factory under `name`."""
    def _add(factory):
        SUITES[name] = factory
        return factory
    return _add


def get_suite(name: str, **knobs) -> Sweep:
    """Build the named suite (knobs forward to its factory)."""
    if name not in SUITES:
        raise KeyError(f"unknown suite {name!r}; "
                       f"available: {sorted(SUITES)}")
    return SUITES[name](**knobs)


def list_suites() -> List[str]:
    return sorted(SUITES)


# ------------------------------------------------------------ paper tables
@register_suite("table1_paper")
def table1_paper(num_flows: int = 400) -> Sweep:
    """Table 1's three scenarios (CacheFollower/DCTCP, Hadoop/TIMELY,
    Hadoop/DCTCP 1-to-1) — flowSim vs the packet-level ground truth."""
    return Sweep("table1_paper", (
        ScenarioSpec(name="CacheFollower/DCTCP/4-1", oversub="4-to-1",
                     cc="dctcp", size_dist="CacheFollower", max_load=0.35,
                     sigma=1.0, matrix="A", num_flows=num_flows, seed=101),
        ScenarioSpec(name="Hadoop/TIMELY/4-1", oversub="4-to-1",
                     cc="timely", size_dist="Hadoop", max_load=0.58,
                     sigma=1.0, matrix="C", num_flows=num_flows, seed=102),
        ScenarioSpec(name="Hadoop/DCTCP/1-1", oversub="1-to-1",
                     cc="dctcp", size_dist="Hadoop", max_load=0.74,
                     sigma=2.0, matrix="C", num_flows=num_flows, seed=103),
    ))


@register_suite("table3_empirical")
def table3_empirical(num_flows: int = 300) -> Sweep:
    """Table 3's held-out empirical workloads (trained on synthetic,
    tested on the Meta CDFs)."""
    return Sweep("table3_empirical", tuple(
        ScenarioSpec(name=dist, oversub="2-to-1", cc="dctcp",
                     size_dist=dist, max_load=0.5, sigma=1.0, matrix="B",
                     num_flows=num_flows, seed=200 + i)
        for i, dist in enumerate(["CacheFollower", "WebServer", "Hadoop"])))


@register_suite("table4_scaling")
def table4_scaling(flows_base: int = 150,
                   sizes=((8, 4), (16, 8), (32, 8), (64, 16))) -> Sweep:
    """Table 4's runtime-scaling rows: growing fat-trees ((racks,
    hosts/rack) in `sizes`) with proportionally growing flow counts.
    Shapes intentionally differ per row — run with chunk_size=1 so each
    row's wall time is its own."""
    return Sweep("table4_scaling", tuple(
        ScenarioSpec(name=f"{racks}racks",
                     topo=f"ft-{racks}x{hpr}x{max(2, hpr // 2)}",
                     cc="dctcp", size_dist="WebServer", max_load=0.5,
                     sigma=1.0, matrix="A",
                     num_flows=flows_base * racks // 8, seed=300 + racks)
        for racks, hpr in sizes))


# ------------------------------------------------------------- Table-2 space
@register_suite("table2_train_space")
def table2_train_space(n: int = 32, num_flows: int = 2000, seed0: int = 0,
                       synthetic: bool = True) -> Sweep:
    """The paper's training distribution: uniform random points of the
    full Table-2 space (topology oversubscription x CC scheme x synthetic
    size distribution x burstiness x load x matrix, §5.1). Identical to
    `sample_scenario(seed0..seed0+n-1)` by construction."""
    return Sweep.random("table2_train_space", n, seed0=seed0,
                        num_flows=num_flows, synthetic=synthetic)


@register_suite("table2_grid")
def table2_grid(num_flows: int = 500) -> Sweep:
    """Exhaustive grid over Table-2's discrete axes (72 points); the
    continuous axes stay at spec defaults."""
    return Sweep.grid(
        "table2_grid", ScenarioSpec(num_flows=num_flows),
        oversub=["1-to-1", "2-to-1", "4-to-1"],
        cc=["dctcp", "dcqcn", "timely"],
        size_dist=["pareto", "exp", "gaussian", "lognormal"],
        sigma=[1.0, 2.0])


# ------------------------------------------------------------- beyond paper
@register_suite("beyond_paper")
def beyond_paper(num_flows: int = 400) -> Sweep:
    """Workload families outside the paper's Table 2: incast fan-in
    bursts, ring-collective shifted permutations, full all-to-all
    exchanges, and the mixed empirical-CDF workload — where synchronized
    arrivals stress exactly what flowSim gets wrong (§2.2)."""
    inc = Sweep.grid("incast", ScenarioSpec(workload="incast",
                                            size_dist="WebServer",
                                            num_flows=num_flows, seed=400),
                     fan_in=[8, 16, 32], max_load=[0.4, 0.7])
    perm = Sweep.grid("permutation", ScenarioSpec(workload="permutation",
                                                  num_flows=num_flows,
                                                  seed=410),
                      participants=[8, 16], max_load=[0.5])
    a2a = Sweep.grid("all_to_all", ScenarioSpec(workload="all_to_all",
                                                theta=50e3,
                                                num_flows=num_flows,
                                                seed=420),
                     participants=[8, 16], max_load=[0.5])
    mixed = Sweep("mixed", (
        ScenarioSpec(name="mixed-empirical", size_dist="mixed",
                     max_load=0.6, num_flows=num_flows, seed=430),))
    sweep = inc + perm + a2a + mixed
    return Sweep("beyond_paper", sweep.specs)


# ------------------------------------------------------------------- smoke
@register_suite("smoke16")
def smoke16(num_flows: int = 30) -> Sweep:
    """16 shape-diverse CPU-sized scenarios: four topologies x varying
    flow counts x all four workload families. Exercises chunked padding
    end to end: a chunk of 8 pads over all four topologies."""
    specs = []
    topos = ["paper", "ft-4x2x2", "ft-8x2x2", "ft-4x4x2"]
    workloads = ["table2", "incast", "permutation", "all_to_all"]
    dists = ["lognormal", "WebServer", "mixed", "exp"]
    for i in range(16):
        specs.append(ScenarioSpec(
            name=f"smoke-{i}", topo=topos[i % 4],
            oversub=["1-to-1", "2-to-1", "4-to-1"][i % 3],
            cc=["dctcp", "dcqcn", "timely"][i % 3],
            workload=workloads[(i // 4) % 4], size_dist=dists[i % 4],
            max_load=0.3 + 0.05 * (i % 5), sigma=1.0 + (i % 2),
            num_flows=num_flows + 4 * i, seed=500 + i,
            fan_in=4, participants=4))
    return Sweep("smoke16", tuple(specs))


# -------------------------------------------------------------- divergence
@register_suite("divergence_worst")
def divergence_worst(report: str = "results/divergence/report.json",
                     k: int = 8, num_flows: int = 0) -> Sweep:
    """The K worst-divergence scenarios of a divergence report (the JSON
    that the JAX package's `python -m repro.obs.diff` writes),
    re-materialized from its embedded `worst_specs` — what training
    oversamples to fix exactly where m4 disagrees with the oracle. The
    report JSON is read directly; `num_flows > 0` rescales every spec."""
    with open(report) as fh:
        rep = json.load(fh)
    specs = [spec_from_dict(d) for d in rep.get("worst_specs", [])[:k]]
    if not specs:
        raise ValueError(f"{report}: no worst_specs recorded (write a "
                         "divergence report first)")
    if num_flows:
        specs = [dataclasses.replace(s, num_flows=num_flows) for s in specs]
    return Sweep("divergence_worst", tuple(specs))
