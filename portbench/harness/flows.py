"""What the two flow lanes (`portbench/lanes/m4.py`, `flowsim_fast.py`)
share: the Table-2 pool, the port's requests, one `run_many` a call, and
the comparison of completion times.

A flow lane turns the benchmark's plain scenarios into the port's
requests (`repro_torch.sim.SimRequest`, with the port's own `FatTree`,
`NetConfig` and `Flow`) and drives `repro_torch.sim.get_backend(lane)
.run_many` on them. Its answers are each scenario's completion times.

The numbers compared, over every completion time that the window's
calls returned against the plain reference's for the same scenario,
each with its limit in `portbench/cells/<cell>.json`:

- `fct_rel_max`: the largest relative gap |got - ref| / ref of any flow;
- `fct_rel_p99`: the 99th percentile of the relative gaps of all flows;
- `answer_rel_p50_max`: per answer (one scenario's completion times, as
  one request of a call returned them) the median relative gap of its
  flows, and the largest of these over every answer of the window.

A flow with no finite time, or of an answer that did not come back, has
an infinite gap.
"""
from __future__ import annotations

import numpy as np

from . import gen, lanes


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


def gaps(calls, refs):
    """Relative gaps of every flow of every answer, one array an answer.
    `calls`: [(pool index, [fcts per scenario])]; `refs`: pool index ->
    [reference times per scenario]."""
    rel = []
    for k, fcts in calls:
        for b, want in enumerate(refs[k]):
            got = fcts[b] if b < len(fcts) else None
            w = np.asarray(want, np.float64)
            if got is None or len(got) != len(want):
                got = np.full(len(w), np.nan)
            got = np.asarray(got, np.float64)
            ok = np.isfinite(got)
            gap = np.full(len(w), np.inf)
            gap[ok] = np.abs(got[ok] - w[ok]) / np.abs(w[ok])
            rel.append(gap)
    return rel


def numbers(calls, refs) -> dict:
    per = gaps(calls, refs)
    rel = np.concatenate(per) if per else np.zeros(0)
    inf = float("inf")
    return {"fct_rel_max": float(rel.max()) if rel.size else inf,
            "fct_rel_p99": float(np.quantile(rel, 0.99)) if rel.size
            else inf,
            "answer_rel_p50_max": max((float(np.median(r)) if r.size
                                       else inf for r in per), default=inf)}


def failed(outs, refs) -> int:
    """Scenarios of the window that came back without a finite time for
    every flow."""
    return sum(b >= len(fcts) or len(fcts[b]) != len(want)
               or not np.isfinite(fcts[b]).all()
               for k, fcts in outs for b, want in enumerate(refs[k]))


def events(run) -> int:
    """Batched events of the traced calls: 2N a call."""
    return 2 * run.num_flows * len(run.traced_calls)


class FlowLane(lanes.Lane):
    """A lane of `run_many` over Table-2 scenarios: the pool from
    `gen.pool`, a call's answers each scenario's completion times, its
    units the flows."""

    def pool(self, seed):
        return gen.pool(self.config, self.traffic, seed)

    def inputs(self, batch, device):
        return requests(batch)

    def call(self, backend, inputs):
        res = backend.run_many(inputs)
        return ([np.asarray(r.fcts) for r in res],
                sum(len(r.fcts) for r in res), len(res))

    def release(self, backend):
        from repro_torch.core import compiled
        compiled.clear_compiled()

    def numbers(self, outs, refs):
        return numbers(outs, refs)

    def quantiles(self, outs, refs):
        """Quantiles of all flows' relative gaps, and of the answers'
        medians."""
        per = gaps(outs, refs)
        rel = np.concatenate(per)
        out = {f"q{q:g}": float(np.quantile(rel, q))
               for q in (0.5, 0.9, 0.99, 0.999, 1.0)}
        out["answer_medians"] = [float(np.median(r)) for r in per]
        return out

    def failed(self, outs, refs):
        return failed(outs, refs)

    def fields(self, pool):
        return {"batch": self.traffic["batch"],
                "num_flows": self.traffic["num_flows"],
                "num_links": {k: max(s.net.num_links for s in b)
                              for k, b in enumerate(pool)},
                "nnz": {k: [sum(len(p) for p in s.paths) for s in b]
                        for k, b in enumerate(pool)}}
