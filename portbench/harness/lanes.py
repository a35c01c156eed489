"""The system under test, one lane per backend of the port, and its
reference.

A lane turns the benchmark's plain scenarios into the port's requests
(`repro_torch.sim.SimRequest`, with the port's own `FatTree`, `NetConfig`
and `Flow`), builds the backend the window drives
(`repro_torch.sim.get_backend(lane).run_many`), and runs the plain
reference of `portbench/reference/` over the same scenarios. The port is
imported only here and in the run's set-up, never by the reference.
"""
from __future__ import annotations

import numpy as np


def requests(scenarios):
    """The port's `SimRequest` of each plain scenario."""
    from repro_torch.net import FatTree, Flow, NetConfig
    from repro_torch.sim import SimRequest
    out = []
    for s in scenarios:
        n = s.net
        topo = FatTree(num_racks=n.num_racks, hosts_per_rack=n.hosts_per_rack,
                       num_spines=n.num_spines, link_gbps=n.link_gbps,
                       prop_delay_s=n.prop_delay_s, oversub=n.oversub)
        if topo.num_links != n.num_links:
            raise RuntimeError("the port's fat tree lays out another number "
                               f"of links: {topo.num_links} != {n.num_links}")
        knobs = {k: float(s.point[k]) for k in (
            "init_window", "buffer_bytes", "dctcp_k", "dcqcn_kmin",
            "dcqcn_kmax", "timely_tlow", "timely_thigh")}
        config = NetConfig(cc=str(s.point["cc"]), **knobs)
        flows = tuple(Flow(fid=i, src=int(s.src[i]), dst=int(s.dst[i]),
                           size=int(s.size[i]),
                           t_arrival=float(s.t_arrival[i]),
                           path=list(s.paths[i]))
                      for i in range(s.num_flows))
        out.append(SimRequest(topo=topo, config=config, flows=flows))
    return out


class Lane:
    """What one lane needs: the backend, and the reference of a batch."""

    name = "?"

    def backend(self, weights, device):
        raise NotImplementedError

    def reference(self, scenarios, weights, device, *, control=False):
        """(each scenario's completion times as the backend reports them,
        the counts that the per-layer metrics read)."""
        raise NotImplementedError


class M4Lane(Lane):
    name = "m4"

    def __init__(self, model: dict):
        self.model = model

    def backend(self, weights, device):
        from repro_torch.core.model import M4Config
        from repro_torch.sim import get_backend
        keys = ("hidden", "gnn_dim", "mlp_hidden", "gnn_layers", "snap_flows",
                "snap_links", "max_path", "cfg_dim")
        cfg = M4Config(**{k: self.model[k] for k in keys})
        return get_backend("m4", params=weights, cfg=cfg, device=device)

    def reference(self, scenarios, weights, device, *, control=False):
        from ..reference import m4
        fct, live = m4.run(scenarios, weights, self.model, device,
                           tf32=control)
        return ([fct[b, :s.num_flows] for b, s in enumerate(scenarios)],
                {"live_edges": live})


class FlowSimLane(Lane):
    name = "flowsim_fast"

    def backend(self, weights, device):
        from repro_torch.sim import get_backend
        return get_backend("flowsim_fast", device=device)

    def reference(self, scenarios, weights, device, *, control=False):
        from ..reference import flowsim
        fct_abs, rounds = flowsim.run(scenarios, control=control)
        # the backend reports completion minus arrival, in float64
        return ([fct_abs[b, :s.num_flows].astype(np.float64) - s.t_arrival
                 for b, s in enumerate(scenarios)], {"rounds": rounds})


def lane(traffic: dict, config: dict) -> Lane:
    name = traffic["lane"]
    if name == "m4":
        return M4Lane(config["model"])
    if name == "flowsim_fast":
        return FlowSimLane()
    raise ValueError(f"unknown lane {name!r}")
