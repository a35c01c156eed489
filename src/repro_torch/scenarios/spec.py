"""Declarative scenario specs + sweep definitions over the Table-2 space.

A copy of `repro.scenarios.spec` on the port's own traffic layer:
`ScenarioSpec` freezes one scenario as primitives only (topology *name*,
CC knob overrides, workload family, seed) — hashable, replace()-able, and
cheap to enumerate, unlike the materialized `Scenario` which owns a
`FatTree` and a `NetConfig`. `Sweep.grid` / `Sweep.random` build suites of
specs over the paper's Table-2 parameter space (§5.1) and the beyond-paper
workload families (`repro_torch.data.traffic.WORKLOADS`); `random_spec(seed)`
freezes the exact scenario `repro_torch.data.traffic.sample_scenario(seed)`
draws, so declarative sweeps and the legacy sampler can never diverge.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass
from typing import Iterator, Sequence, Tuple

import numpy as np

from ..data.traffic import (NET_KNOBS, WORKLOADS, Scenario, sample_point)
from ..net.config import NetConfig
from ..net.topology import FatTree, paper_train_topo
from ..sim.api import SimRequest


@dataclass(frozen=True)
class ScenarioSpec:
    """One scenario of the Table-2 space (§5.1), as pure data.

    `topo` is a name: "paper" (the 8-rack training fat-tree, spines set by
    `oversub`) or "ft-RxHxS" (R racks × H hosts/rack × S spines at
    `link_gbps`). `net` carries NetConfig knob overrides as a tuple of
    (field, value) pairs so the spec stays hashable. Everything else
    mirrors `repro_torch.data.traffic.Scenario` one-to-one.
    """
    name: str = ""
    topo: str = "paper"
    oversub: str = "2-to-1"
    link_gbps: float = 10.0
    cc: str = "dctcp"
    net: Tuple[Tuple[str, float], ...] = ()
    workload: str = "table2"
    size_dist: str = "lognormal"
    theta: float = 20e3
    sigma: float = 1.0
    max_load: float = 0.5
    matrix: str = "A"
    num_flows: int = 2000
    seed: int = 0
    fan_in: int = 16
    participants: int = 8

    def __post_init__(self):
        if self.workload not in WORKLOADS:
            raise ValueError(f"unknown workload {self.workload!r}; "
                             f"available: {sorted(WORKLOADS)}")

    # ------------------------------------------------------- materialize
    def build_topo(self) -> FatTree:
        """Resolve the topology name into a `FatTree`."""
        if self.topo == "paper":
            return paper_train_topo(self.oversub)
        if self.topo.startswith("ft-"):
            try:
                r, h, s = (int(x) for x in self.topo[3:].split("x"))
            except ValueError:
                raise ValueError(f"bad topo spec {self.topo!r} "
                                 "(want 'ft-RxHxS')") from None
            return FatTree(num_racks=r, hosts_per_rack=h, num_spines=s,
                           link_gbps=self.link_gbps, oversub=self.oversub)
        raise ValueError(f"unknown topo {self.topo!r} "
                         "(want 'paper' or 'ft-RxHxS')")

    def build_config(self) -> NetConfig:
        """NetConfig with this spec's CC scheme + knob overrides."""
        return NetConfig(cc=self.cc, **dict(self.net))

    def to_scenario(self) -> Scenario:
        """Materialize into the traffic layer's `Scenario` generator."""
        return Scenario(
            topo=self.build_topo(), config=self.build_config(),
            size_dist=self.size_dist, theta=self.theta, sigma=self.sigma,
            max_load=self.max_load, matrix=self.matrix,
            num_flows=self.num_flows, seed=self.seed,
            workload=self.workload, fan_in=self.fan_in,
            participants=self.participants)

    def to_request(self, **options) -> SimRequest:
        """Materialize into a `repro_torch.sim.SimRequest` (generates the
        flows)."""
        return SimRequest.from_scenario(self.to_scenario(), **options)

    @property
    def label(self) -> str:
        """Short human-readable row label for result tables."""
        if self.name:
            return self.name
        return (f"{self.workload}/{self.size_dist}/{self.cc}/"
                f"{self.oversub}/l{self.max_load:.2f}/s{self.seed}")


def random_spec(seed: int, *, num_flows: int = 2000,
                synthetic: bool = True) -> ScenarioSpec:
    """Freeze one random Table-2 point as a spec.

    Draws through `repro_torch.data.traffic.sample_point` with the same
    rng stream `sample_scenario(seed)` uses, so
    `random_spec(seed).to_scenario()` generates the *identical* flows.
    """
    rng = np.random.default_rng(seed)
    # numpy scalars -> plain floats once, up front: the spec is pure
    # hashable data and must never hold array-typed leaves
    p = {k: float(v) if isinstance(v, (int, float, np.floating)) else str(v)
         for k, v in sample_point(rng, synthetic=synthetic).items()}
    return ScenarioSpec(
        name=f"table2-{'synth' if synthetic else 'emp'}-{seed}",
        topo="paper", oversub=p["oversub"], cc=p["cc"],
        net=tuple((k, p[k]) for k in NET_KNOBS),
        size_dist=p["size_dist"], theta=p["theta"],
        sigma=p["sigma"], max_load=p["max_load"],
        matrix=p["matrix"], num_flows=num_flows, seed=seed)


_FIELDS = {f.name for f in dataclasses.fields(ScenarioSpec)}


def spec_to_dict(spec: ScenarioSpec) -> dict:
    """JSON-safe dict of one spec (`net` pairs become lists)."""
    d = dataclasses.asdict(spec)
    d["net"] = [[k, v] for k, v in spec.net]
    return d


def spec_from_dict(d: dict) -> ScenarioSpec:
    """Inverse of `spec_to_dict`; unknown keys are rejected so a stale
    divergence report can't silently half-build a scenario."""
    d = dict(d)
    bad = set(d) - _FIELDS
    if bad:
        raise ValueError(f"unknown ScenarioSpec fields {sorted(bad)}")
    if "net" in d:
        d["net"] = tuple((str(k), float(v)) for k, v in d["net"])
    return ScenarioSpec(**d)


@dataclass(frozen=True)
class Sweep:
    """A named, ordered suite of `ScenarioSpec`s (what `SweepRunner` runs)."""
    name: str
    specs: Tuple[ScenarioSpec, ...]

    def __len__(self) -> int:
        return len(self.specs)

    def __iter__(self) -> Iterator[ScenarioSpec]:
        return iter(self.specs)

    def __add__(self, other: "Sweep") -> "Sweep":
        return Sweep(name=f"{self.name}+{other.name}",
                     specs=self.specs + tuple(other.specs))

    def limit(self, n: int) -> "Sweep":
        """First `n` specs (CLI --limit)."""
        return Sweep(name=self.name, specs=self.specs[:n])

    @staticmethod
    def grid(name: str, base: ScenarioSpec = None,
             **axes: Sequence) -> "Sweep":
        """Cartesian product over spec fields (the Table-2 grid, §5.1).

            Sweep.grid("cc-x-load", cc=["dctcp", "timely"],
                       max_load=[0.3, 0.8])

        Each axis is a spec field name with the list of values to sweep;
        every grid point is `base` with those fields replaced. Point names
        encode their coordinates.
        """
        base = base if base is not None else ScenarioSpec()
        bad = set(axes) - _FIELDS
        if bad:
            raise ValueError(f"unknown spec fields {sorted(bad)}; "
                             f"axes must be ScenarioSpec fields")
        keys = list(axes)
        specs = []
        for values in itertools.product(*(axes[k] for k in keys)):
            pt = dict(zip(keys, values))
            tag = "/".join(str(v) for v in values)
            specs.append(dataclasses.replace(
                base, name=f"{name}[{tag}]", **pt))
        return Sweep(name=name, specs=tuple(specs))

    @staticmethod
    def random(name: str, n: int, *, seed0: int = 0, num_flows: int = 2000,
               synthetic: bool = True) -> "Sweep":
        """`n` random Table-2 points (the paper's training-set sampler,
        §5.1), seeds seed0..seed0+n-1."""
        return Sweep(name=name, specs=tuple(
            random_spec(seed0 + i, num_flows=num_flows, synthetic=synthetic)
            for i in range(n)))
