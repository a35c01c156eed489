"""Fat-tree topologies with plane-level oversubscription and ECMP paths.

A copy of `repro.net.topology.FatTree`, `paper_train_topo` and
`meta_fabric`: the port keeps its own so that it never imports the JAX
package. Links are unidirectional with integer ids; a flow's path is the
list of link ids it traverses (host->tor, tor->spine, spine->tor,
tor->host).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass
class FatTree:
    num_racks: int
    hosts_per_rack: int
    num_spines: int
    link_gbps: float = 10.0
    prop_delay_s: float = 1e-6
    oversub: str = "1-to-1"

    # filled by __post_init__
    num_hosts: int = field(init=False)
    num_links: int = field(init=False)
    capacity: np.ndarray = field(init=False)     # bits/s per link
    prop: np.ndarray = field(init=False)

    def __post_init__(self):
        self.num_hosts = self.num_racks * self.hosts_per_rack
        H, R, S = self.num_hosts, self.num_racks, self.num_spines
        # link layout (unidirectional):
        #   [0,H)                host -> tor
        #   [H,2H)               tor  -> host
        #   [2H, 2H+R*S)         tor  -> spine  (tor r, spine s) = 2H + r*S + s
        #   [2H+R*S, 2H+2R*S)    spine-> tor
        self.num_links = 2 * H + 2 * R * S
        c = self.link_gbps * 1e9
        self.capacity = np.full(self.num_links, c)
        self.prop = np.full(self.num_links, self.prop_delay_s)

    # --- link id helpers -------------------------------------------------
    def up_host(self, h):
        return h

    def down_host(self, h):
        return self.num_hosts + h

    def up_tor(self, r, s):
        return 2 * self.num_hosts + r * self.num_spines + s

    def down_tor(self, r, s):
        return 2 * self.num_hosts + self.num_racks * self.num_spines \
            + r * self.num_spines + s

    def rack_of(self, h):
        return h // self.hosts_per_rack

    def path(self, src: int, dst: int, flow_id: int = 0) -> List[int]:
        """ECMP: spine chosen by flow hash."""
        rs, rd = self.rack_of(src), self.rack_of(dst)
        if src == dst:
            return []
        if rs == rd:
            return [self.up_host(src), self.down_host(dst)]
        s = (flow_id * 2654435761 + src * 97 + dst) % self.num_spines
        return [self.up_host(src), self.up_tor(rs, s),
                self.down_tor(rd, s), self.down_host(dst)]

    def ideal_fct(self, size_bytes: int, path: List[int]) -> float:
        """Unloaded completion time: bottleneck serialization + prop + per-hop
        store-and-forward of one MTU (matches flowSim's convention)."""
        if not path:
            return 1e-9
        cap = min(self.capacity[l] for l in path)
        prop = sum(self.prop[l] for l in path)
        mtu = 1000.0
        sf = sum(mtu * 8.0 / self.capacity[l] for l in path[1:])
        return size_bytes * 8.0 / cap + prop + sf


def paper_train_topo(oversub: str = "4-to-1") -> FatTree:
    """8-rack, 32-host training topology (§5.1), 10G links."""
    spines = {"1-to-1": 4, "2-to-1": 2, "4-to-1": 1}[oversub]
    return FatTree(num_racks=8, hosts_per_rack=4, num_spines=spines,
                   oversub=oversub)


def meta_fabric(num_pods: int = 8, racks_per_pod: int = 48,
                hosts_per_rack: int = 16, oversub: str = "2-to-1") -> FatTree:
    """Meta data-center-fabric-style large topology (§5.2), flattened to
    leaf/spine with equivalent oversubscription."""
    racks = num_pods * racks_per_pod
    spines = max(1, hosts_per_rack // int(oversub.split("-")[0]))
    return FatTree(num_racks=racks, hosts_per_rack=hosts_per_rack,
                   num_spines=spines, oversub=oversub)
