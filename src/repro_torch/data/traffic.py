"""Traffic/scenario generator — the paper's Table 2 parameter space.

A copy of the `table2` part of `repro.data.traffic`: synthetic flow-size
distributions (Pareto/Exp/Gaussian/Lognormal with scale θ ∈ [5K, 50K]),
the empirical Meta-style CDFs, lognormal inter-arrivals with burstiness
σ ∈ {1, 2}, rack-to-rack traffic matrices A/B/C and max-link-load
targeting. The numpy rng is consumed in the same order as the JAX
package's generator, so one seed gives the same flows in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..net.config import Flow, NetConfig
from ..net.topology import FatTree, paper_train_topo

# ---------------------------------------------------------------- sizes
SYNTH_DISTS = ["pareto", "exp", "gaussian", "lognormal"]
# piecewise (bytes, cdf) approximations of the Meta workloads
EMPIRICAL = {
    # mostly medium/large flows (database)
    "CacheFollower": ([500, 2e3, 10e3, 50e3, 200e3, 1e6], [0.1, 0.3, 0.55, 0.8, 0.95, 1.0]),
    # dominated by small responses
    "WebServer": ([300, 1e3, 3e3, 10e3, 50e3, 200e3], [0.35, 0.6, 0.8, 0.92, 0.99, 1.0]),
    # bimodal: control msgs + large shuffles
    "Hadoop": ([300, 1e3, 5e3, 30e3, 300e3, 2e6], [0.5, 0.65, 0.8, 0.9, 0.99, 1.0]),
}
SIZE_BOUNDS = (200, 5e6)   # bytes; every sampler clips into this range


def sample_sizes(rng, dist: str, n: int, theta: float = 20e3) -> np.ndarray:
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
        u = rng.random(n)
        logp = np.log(np.array([pts[0] / 3] + list(pts)))
        cdfp = np.array([0.0] + list(cdf))
        s = np.exp(np.interp(u, cdfp, logp))
    elif dist == "mixed":
        # one scenario interleaving all three Meta CDFs
        keys = list(EMPIRICAL)
        which = rng.integers(0, len(keys), n)
        s = np.empty(n)
        for i, k in enumerate(keys):
            m = which == i
            if m.any():
                s[m] = sample_sizes(rng, k, int(m.sum()), theta)
    else:
        raise ValueError(dist)
    return np.clip(s, *SIZE_BOUNDS).astype(np.int64)


def traffic_matrix(rng, kind: str, num_racks: int) -> np.ndarray:
    """Rack-to-rack probability matrix. A=database (uniform-ish),
    B=web (skewed hot racks), C=hadoop (rack-local heavy)."""
    if kind == "A":
        m = np.ones((num_racks, num_racks)) + 0.3 * rng.random((num_racks, num_racks))
    elif kind == "B":
        hot = rng.random(num_racks) ** 3
        m = np.outer(hot + 0.1, np.ones(num_racks)) + 0.2
    elif kind == "C":
        m = 0.3 * np.ones((num_racks, num_racks)) + 3.0 * np.eye(num_racks)
    else:
        raise ValueError(kind)
    np.fill_diagonal(m, m.diagonal() * 0.5)  # keep some intra-rack
    return m / m.sum()


# ------------------------------------------------------- declarative space
# Axis -> draw rule, in DRAW ORDER (sample_point consumes the rng stream in
# dict order; changing the order silently changes every seeded scenario).
# "choice" axes draw uniformly from the tuple; "uniform" axes from [lo, hi).
TABLE2_SPACE: Dict[str, tuple] = {
    "oversub": ("choice", ("1-to-1", "2-to-1", "4-to-1")),
    "cc": ("choice", ("dctcp", "dcqcn", "timely")),
    "init_window": ("uniform", 5e3, 15e3),
    "buffer_bytes": ("uniform", 100e3, 160e3),
    "dctcp_k": ("uniform", 10e3, 30e3),
    "dcqcn_kmin": ("uniform", 10e3, 30e3),
    "dcqcn_kmax": ("uniform", 30e3, 50e3),
    "timely_tlow": ("uniform", 40e-6, 60e-6),
    "timely_thigh": ("uniform", 100e-6, 150e-6),
    "size_dist": ("workload-dependent", None),   # SYNTH_DISTS or EMPIRICAL
    "theta": ("uniform", 5e3, 50e3),
    "sigma": ("choice", (1.0, 2.0)),
    "max_load": ("uniform", 0.3, 0.8),
    "matrix": ("choice", ("A", "B", "C")),
}
# the TABLE2_SPACE axes that are NetConfig congestion-control knobs
NET_KNOBS = ("init_window", "buffer_bytes", "dctcp_k", "dcqcn_kmin",
             "dcqcn_kmax", "timely_tlow", "timely_thigh")


def sample_point(rng, synthetic: bool = True) -> Dict[str, object]:
    """Draw one Table-2 parameter point (primitives only, no objects)."""
    point: Dict[str, object] = {}
    for name, axis in TABLE2_SPACE.items():
        if name == "size_dist":
            pool = SYNTH_DISTS if synthetic else list(EMPIRICAL.keys())
            point[name] = str(rng.choice(pool))
        elif axis[0] == "choice":
            v = rng.choice(list(axis[1]))
            point[name] = str(v) if isinstance(v, str) else float(v)
        else:
            point[name] = float(rng.uniform(axis[1], axis[2]))
    return point


@dataclass
class Scenario:
    """One materialized point of the Table-2 space.

    Only the paper's "table2" workload (matrix-driven src/dst, §5.1) is
    here; the incast, permutation and all_to_all families stay with the
    JAX package for now.
    """
    topo: FatTree
    config: NetConfig
    size_dist: str = "lognormal"
    theta: float = 20e3
    sigma: float = 1.0            # burstiness
    max_load: float = 0.5
    matrix: str = "A"
    num_flows: int = 2000
    seed: int = 0
    workload: str = "table2"

    def generate(self) -> List[Flow]:
        """Deterministically materialize the flow list (fixed `seed` ->
        identical flows, across calls, processes and packages)."""
        if self.workload != "table2":
            raise ValueError(f"unknown workload {self.workload!r}; "
                             "available: ['table2']")
        rng = np.random.default_rng(self.seed)
        return self._gen_table2(rng)

    def _gen_table2(self, rng) -> List[Flow]:
        """The paper's workload: matrix-driven src/dst, sampled sizes,
        lognormal inter-arrivals scaled to hit `max_load` (§5.1)."""
        topo = self.topo
        sizes = sample_sizes(rng, self.size_dist, self.num_flows, self.theta)
        tm = traffic_matrix(rng, self.matrix, topo.num_racks)
        pairs = rng.choice(topo.num_racks ** 2, size=self.num_flows,
                           p=tm.reshape(-1))
        src_r, dst_r = pairs // topo.num_racks, pairs % topo.num_racks
        src = src_r * topo.hosts_per_rack + rng.integers(
            0, topo.hosts_per_rack, self.num_flows)
        dst = dst_r * topo.hosts_per_rack + rng.integers(
            0, topo.hosts_per_rack, self.num_flows)
        same = src == dst
        dst[same] = (dst[same] + 1) % topo.num_hosts

        # target the max link load: estimate the busiest link's bytes/sec at
        # unit arrival rate, then scale the mean inter-arrival accordingly.
        paths = [topo.path(int(s), int(d), i) for i, (s, d) in enumerate(zip(src, dst))]
        per_link = np.zeros(topo.num_links)
        for p, sz in zip(paths, sizes):
            for l in p:
                per_link[l] += sz * 8.0
        busiest = per_link.max() / self.num_flows  # bits per flow on hottest link
        mean_gap = busiest / (self.max_load * topo.capacity.max())
        gaps = rng.lognormal(np.log(max(mean_gap, 1e-9)) - self.sigma ** 2 / 2,
                             self.sigma, self.num_flows)
        t_arr = np.cumsum(gaps)
        t_arr -= t_arr[0]

        return [Flow(fid=i, src=int(src[i]), dst=int(dst[i]),
                     size=int(sizes[i]), t_arrival=float(t_arr[i]),
                     path=paths[i])
                for i in range(self.num_flows)]


def sample_scenario(seed: int, *, num_flows: int = 2000,
                    synthetic: bool = True,
                    topo: Optional[FatTree] = None) -> Scenario:
    """Random point of Table 2. synthetic=True -> training distributions."""
    rng = np.random.default_rng(seed)
    point = sample_point(rng, synthetic=synthetic)
    topo = topo or paper_train_topo(str(point["oversub"]))
    config = NetConfig(cc=str(point["cc"]),
                       **{k: float(point[k]) for k in NET_KNOBS})
    return Scenario(
        topo=topo, config=config, size_dist=str(point["size_dist"]),
        theta=float(point["theta"]), sigma=float(point["sigma"]),
        max_load=float(point["max_load"]), matrix=str(point["matrix"]),
        num_flows=num_flows, seed=seed)
