"""Closed-loop traffic (§5.4): per-rack inflight limit N; a new flow may
only start when an earlier flow of the same rack completes.

A copy of `repro.core.closedloop`: the workload generator `make_backlog`,
and `run_closed_loop`, re-exported from `repro_torch.sim.closedloop`:

    from repro_torch.core.closedloop import make_backlog, run_closed_loop
    from repro_torch.sim import get_backend

    res = run_closed_loop(get_backend("flowsim"), topo, config, backlog, N)
"""
from __future__ import annotations

import numpy as np

from ..data.traffic import sample_sizes
from ..net.config import Flow
from ..sim.closedloop import ClosedLoopResult, run_closed_loop  # noqa: F401

__all__ = ["ClosedLoopResult", "run_closed_loop", "make_backlog"]


def make_backlog(topo, *, client_racks, flows_per_rack, size_dist, seed=0):
    """Client racks issue requests to random storage hosts (storage = the
    other racks). The numpy rng is consumed as the JAX package's is, so
    one seed gives the same backlog in both packages."""
    rng = np.random.default_rng(seed)
    racks = list(range(topo.num_racks))
    clients = racks[:client_racks]
    storage = racks[client_racks:]
    backlog, fid = [], 0
    for r in clients:
        rack_flows = []
        sizes = sample_sizes(rng, size_dist, flows_per_rack)
        for s in sizes:
            src = r * topo.hosts_per_rack + rng.integers(topo.hosts_per_rack)
            dr = storage[rng.integers(len(storage))]
            dst = dr * topo.hosts_per_rack + rng.integers(topo.hosts_per_rack)
            rack_flows.append(Flow(fid=fid, src=int(src), dst=int(dst),
                                   size=int(s), t_arrival=0.0,
                                   path=topo.path(int(src), int(dst), fid)))
            fid += 1
        backlog.append(rack_flows)
    return backlog
