"""The benchmark's one traffic generator: scenarios of the m4 paper's
Table-2 space on a two-tier fat tree, as plain numpy records.

A frozen copy of the paper's generator (§5.1, Table 2): a parameter point
(oversubscription, congestion control and its knobs, flow-size
distribution and scale, burstiness, load, rack-to-rack matrix), then the
flows of one scenario: sizes, matrix-driven sources and destinations,
ECMP paths and lognormal inter-arrivals scaled so that the busiest link
carries the point's load. The space and the network come from the
configuration's file, the batch shape from the traffic mix's file.

Seeding. A mix draws its Table-2 points and each scenario's flows from
its own `points_seed`, the same for every run; `--seed` numbers the
flows of each scenario anew (a permutation of their ids, each flow
keeping its ends, size, arrival and path). Every seed therefore runs the
same sizes and arrivals in another order: the same amount of work, with
other arenas, other ties and (m4) other snapshots.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

SIZE_BOUNDS = (200, 5e6)   # bytes; every size law clips into this range
# piecewise (bytes, cdf) approximations of Meta's published workloads
EMPIRICAL = {
    "CacheFollower": ([500, 2e3, 10e3, 50e3, 200e3, 1e6],
                      [0.1, 0.3, 0.55, 0.8, 0.95, 1.0]),
    "WebServer": ([300, 1e3, 3e3, 10e3, 50e3, 200e3],
                  [0.35, 0.6, 0.8, 0.92, 0.99, 1.0]),
    "Hadoop": ([300, 1e3, 5e3, 30e3, 300e3, 2e6],
               [0.5, 0.65, 0.8, 0.9, 0.99, 1.0]),
}


@dataclass
class Network:
    """A two-tier fat tree with unidirectional links, laid out as
    [0, H) host->tor, [H, 2H) tor->host, then tor->spine and spine->tor,
    (rack r, spine s) at r * S + s in each."""
    num_racks: int
    hosts_per_rack: int
    num_spines: int
    link_gbps: float
    prop_delay_s: float
    oversub: str

    @property
    def num_hosts(self) -> int:
        return self.num_racks * self.hosts_per_rack

    @property
    def num_links(self) -> int:
        return 2 * self.num_hosts + 2 * self.num_racks * self.num_spines

    @property
    def capacity_bps(self) -> float:
        return self.link_gbps * 1e9

    def path(self, src: int, dst: int, fid: int) -> List[int]:
        """ECMP: the spine is chosen by a hash of the flow id and ends."""
        H, R, S = self.num_hosts, self.num_racks, self.num_spines
        rs, rd = src // self.hosts_per_rack, dst // self.hosts_per_rack
        if rs == rd:
            return [src, H + dst]
        s = (fid * 2654435761 + src * 97 + dst) % S
        return [src, 2 * H + rs * S + s, 2 * H + R * S + rd * S + s, H + dst]


def network(spec: dict, oversub: str) -> Network:
    """The configuration's network for a point's oversubscription: a
    table of spines per oversubscription, or one fixed fabric."""
    fixed = spec.get("oversub")
    if fixed is not None:
        oversub = fixed
    spines = spec["spines"]
    return Network(num_racks=spec["num_racks"],
                   hosts_per_rack=spec["hosts_per_rack"],
                   num_spines=spines[oversub] if isinstance(spines, dict)
                   else spines,
                   link_gbps=spec["link_gbps"],
                   prop_delay_s=spec["prop_delay_s"], oversub=oversub)


def sample_point(rng, space: Dict[str, list]) -> dict:
    """One Table-2 point: axes drawn in the order the file lists them,
    "choice" uniformly from its values, "uniform" from [lo, hi)."""
    point = {}
    for name, axis in space.items():
        kind, *vals = axis
        if kind == "choice":
            v = rng.choice(list(vals[0]))
            point[name] = str(v) if isinstance(v, str) else float(v)
        elif kind == "uniform":
            point[name] = float(rng.uniform(vals[0], vals[1]))
        else:
            raise ValueError(f"axis {name}: unknown kind {kind!r}")
    return point


def sample_sizes(rng, dist: str, n: int, theta: float) -> np.ndarray:
    if dist == "pareto":
        s = (rng.pareto(1.3, n) + 1) * theta * 0.3
    elif dist == "exp":
        s = rng.exponential(theta, n)
    elif dist == "gaussian":
        s = rng.normal(theta, theta / 3, n)
    elif dist == "lognormal":
        s = rng.lognormal(np.log(theta), 0.8, n)
    elif dist in EMPIRICAL:
        pts, cdf = EMPIRICAL[dist]
        logp = np.log(np.array([pts[0] / 3] + list(pts)))
        s = np.exp(np.interp(rng.random(n), np.array([0.0] + list(cdf)),
                             logp))
    else:
        raise ValueError(f"unknown size law {dist!r}")
    return np.clip(s, *SIZE_BOUNDS).astype(np.int64)


def traffic_matrix(rng, kind: str, racks: int) -> np.ndarray:
    """Rack-to-rack probabilities: A uniform-ish (database), B hot racks
    (web), C rack-local heavy (hadoop)."""
    if kind == "A":
        m = np.ones((racks, racks)) + 0.3 * rng.random((racks, racks))
    elif kind == "B":
        hot = rng.random(racks) ** 3
        m = np.outer(hot + 0.1, np.ones(racks)) + 0.2
    elif kind == "C":
        m = 0.3 * np.ones((racks, racks)) + 3.0 * np.eye(racks)
    else:
        raise ValueError(f"unknown matrix {kind!r}")
    np.fill_diagonal(m, m.diagonal() * 0.5)
    return m / m.sum()


@dataclass
class Scenario:
    """One scenario as plain data: the network, the point (congestion
    control and its knobs included), and per flow its source,
    destination, size in bytes, arrival in seconds and path of link
    ids."""
    net: Network
    point: dict
    src: np.ndarray
    dst: np.ndarray
    size: np.ndarray
    t_arrival: np.ndarray
    paths: List[List[int]]

    @property
    def num_flows(self) -> int:
        return len(self.size)


def flows(rng, net: Network, point: dict, num_flows: int) -> Scenario:
    """The paper's workload at one point: sizes, matrix-driven ends,
    ECMP paths, and lognormal gaps scaled so that the busiest link's
    offered load is the point's `max_load`."""
    sizes = sample_sizes(rng, point["size_dist"], num_flows, point["theta"])
    tm = traffic_matrix(rng, point["matrix"], net.num_racks)
    pairs = rng.choice(net.num_racks ** 2, size=num_flows, p=tm.reshape(-1))
    src_r, dst_r = pairs // net.num_racks, pairs % net.num_racks
    src = src_r * net.hosts_per_rack + rng.integers(
        0, net.hosts_per_rack, num_flows)
    dst = dst_r * net.hosts_per_rack + rng.integers(
        0, net.hosts_per_rack, num_flows)
    same = src == dst
    dst[same] = (dst[same] + 1) % net.num_hosts
    paths = [net.path(int(s), int(d), i) for i, (s, d) in
             enumerate(zip(src, dst))]
    per_link = np.zeros(net.num_links)
    for p, sz in zip(paths, sizes):
        per_link[p] += sz * 8.0
    busiest = per_link.max() / num_flows
    mean_gap = busiest / (point["max_load"] * net.capacity_bps)
    sigma = point["sigma"]
    gaps = rng.lognormal(np.log(max(mean_gap, 1e-9)) - sigma ** 2 / 2,
                         sigma, num_flows)
    t_arr = np.cumsum(gaps)
    t_arr -= t_arr[0]
    return Scenario(net=net, point=point, src=src, dst=dst, size=sizes,
                    t_arrival=t_arr, paths=paths)


def relabel(s: Scenario, perm: np.ndarray) -> Scenario:
    """The scenario with flow j renamed to the flow perm[j] was."""
    return Scenario(net=s.net, point=s.point, src=s.src[perm],
                    dst=s.dst[perm], size=s.size[perm],
                    t_arrival=s.t_arrival[perm],
                    paths=[s.paths[int(j)] for j in perm])


def pool(config: dict, traffic: dict, seed: int) -> List[List[Scenario]]:
    """The `pool` batches of `batch` scenarios a run cycles through: the
    points and flows of scenario i from (the mix's `points_seed`, i), the
    same in every run, their ids permuted by (seed, i)."""
    n = traffic["pool"] * traffic["batch"]
    base = traffic["points_seed"]
    prng = np.random.default_rng(base)
    points = [sample_point(prng, config["space"]) for _ in range(n)]
    scenarios = []
    for i, point in enumerate(points):
        net = network(config["network"], point.get("oversub", ""))
        s = flows(np.random.default_rng([base, i]), net, point,
                  traffic["num_flows"])
        perm = np.random.default_rng([seed % (1 << 64), i]).permutation(
            s.num_flows)
        scenarios.append(relabel(s, perm))
    B = traffic["batch"]
    return [scenarios[i:i + B] for i in range(0, n, B)]
