"""The request/response contract of the port's simulator backends.

A copy of `repro.sim.api`: `SimRequest` freezes one scenario — topology +
congestion-control `NetConfig` + flow list — plus execution options, and
every backend returns a `SimResult`. `content_hash` encodes the same
fields in the same order as the JAX package, so one scenario hashes alike
in both packages.
"""
from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import numpy as np

from ..net.config import Flow, NetConfig
from ..net.topology import FatTree


def _hex(x: float) -> str:
    """Exact, platform-independent float encoding for content hashing."""
    return float(x).hex()


@dataclass(frozen=True)
class SimRequest:
    """One scenario + execution options.

    flows are coerced to a tuple sorted by fid; backends must not mutate
    them.
    """
    topo: FatTree
    config: NetConfig
    flows: Tuple[Flow, ...]
    until: Optional[float] = None      # stop simulated time (None = run out)
    seed: int = 0                      # backend-internal randomness
    record_events: bool = False        # fill SimResult.event_* where supported
    # intermediate-state capture; excluded from content_hash (it changes
    # what is returned, never what is simulated)
    probes: Any = None

    def __post_init__(self):
        # canonicalize: backends index arenas by fid AND iterate positionally,
        # so establish flows[i].fid == i here rather than trusting callers.
        flows = tuple(sorted(self.flows, key=lambda f: f.fid))
        object.__setattr__(self, "flows", flows)
        if [f.fid for f in flows] != list(range(len(flows))):
            raise ValueError(
                "flow fids must be exactly 0..N-1 — they index the "
                "simulator arenas (renumber the flows before building "
                "a SimRequest)")

    @classmethod
    def from_scenario(cls, scenario, **options) -> "SimRequest":
        """Build from a `repro_torch.data.traffic.Scenario`."""
        return cls(topo=scenario.topo, config=scenario.config,
                   flows=tuple(scenario.generate()), **options)

    @property
    def num_flows(self) -> int:
        return len(self.flows)

    def content_hash(self) -> str:
        """Stable sha256 over everything that determines simulator output:
        topology, NetConfig, the full flow list and the execution options
        (floats hex-encoded). `record_events` and `probes` are excluded."""
        h = hashlib.sha256()
        t = self.topo
        parts = ["topo", t.num_racks, t.hosts_per_rack, t.num_spines,
                 _hex(t.link_gbps), _hex(t.prop_delay_s), "cfg"]
        for f in dataclasses.fields(NetConfig):
            v = getattr(self.config, f.name)
            parts.append(_hex(v) if isinstance(v, float) else v)
        parts.append("opts")
        parts.append("none" if self.until is None else _hex(self.until))
        parts.append(self.seed)
        h.update("|".join(map(str, parts)).encode())
        for f in self.flows:
            h.update(("|".join(map(str, [f.fid, f.src, f.dst, f.size,
                                         _hex(f.t_arrival), *f.path]))
                      + "\n").encode())
        return h.hexdigest()


@dataclass(frozen=True)
class SimResult:
    """Uniform per-scenario output (NaN where a flow never finished).
    `raw` carries the backend-native result object."""
    fcts: np.ndarray
    slowdowns: np.ndarray
    wall_time: float
    backend: str = ""
    event_times: Optional[np.ndarray] = None
    event_types: Optional[np.ndarray] = None   # 0 = arrival, 1 = departure
    event_fids: Optional[np.ndarray] = None
    event_remaining: Optional[tuple] = None    # per-event remaining sizes
    event_queues: Optional[tuple] = None       # arrival events: path queue bytes
    probes: Optional[dict] = None
    raw: Any = field(default=None, compare=False)
