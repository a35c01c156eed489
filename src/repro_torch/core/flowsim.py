"""flowSim — the classical max-min fair flow-level simulator (paper §2.1).

A numpy copy of `repro.core.flowsim`. Event-driven: at every flow
arrival/departure, the rates of all active flows are recomputed by
progressive water-filling (float64, at most 64 rounds); between events
remaining sizes drain linearly. It is the paper's CPU baseline (the
`flowsim` backend and the closed-loop `FlowSimSession`) and the oracle of
the port's tests; `repro_torch.core.flowsim_fast` runs the same semantics
on the card.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


def waterfill(cap: np.ndarray, paths: List[np.ndarray]) -> np.ndarray:
    """Progressive-filling max-min rates.

    cap: (L,) link capacities (bits/s); paths: per-flow arrays of link ids.
    Returns (F,) rates. O(#bottlenecks) rounds, each vectorized.
    """
    F = len(paths)
    if F == 0:
        return np.zeros(0, np.float64)
    rates = np.zeros(F, np.float64)
    frozen = np.zeros(F, dtype=bool)
    avail = cap.astype(np.float64).copy()
    flat = np.concatenate(paths)
    fidx = np.repeat(np.arange(F, dtype=np.int64), [len(p) for p in paths])

    for _ in range(64):  # bounded; #distinct bottlenecks <= L
        live = ~frozen[fidx]
        if not live.any():
            break
        n_l = np.zeros(len(cap), np.float64)
        np.add.at(n_l, flat[live], 1.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            share = np.where(n_l > 0, avail / n_l, np.inf)
        # per-flow bottleneck share
        f_share = np.full(F, np.inf, np.float64)
        np.minimum.at(f_share, fidx[live], share[flat[live]])
        theta = f_share[~frozen].min()
        newly = (~frozen) & (f_share <= theta * (1 + 1e-12))
        rates[newly] = f_share[newly]
        # consume capacity on links of newly-frozen flows
        sel = newly[fidx]
        np.add.at(avail, flat[sel], -rates[fidx[sel]])
        avail = np.maximum(avail, 0.0)
        frozen |= newly
        if frozen.all():
            break
    return rates


@dataclass
class FlowSimResult:
    fcts: np.ndarray
    slowdowns: np.ndarray
    # event log: (time, etype, fid)
    event_times: np.ndarray
    event_types: np.ndarray
    event_fids: np.ndarray
    wallclock: float = 0.0
    # finalized `repro.obs.timeseries/1` dict of a probed flowsim_fast run
    probes: object = None


def run_flowsim(topo, flows, until: Optional[float] = None,
                record_events: bool = False) -> FlowSimResult:
    """flows: objects with .fid, .size (bytes), .t_arrival, .path."""
    t0 = time.perf_counter()
    n = len(flows)
    order = np.argsort([f.t_arrival for f in flows], kind="stable")
    arrive_ptr = 0
    active: List[int] = []
    remaining = np.array([float(f.size) * 8.0 for f in flows])  # bits
    fct = np.full(n, np.nan, np.float64)
    t = 0.0
    rates = np.zeros(0, np.float64)
    ev_t, ev_k, ev_f = [], [], []

    def recompute():
        return waterfill(topo.capacity, [np.asarray(flows[i].path, np.int64)
                                         for i in active])

    while True:
        nxt_arr = (flows[order[arrive_ptr]].t_arrival
                   if arrive_ptr < n else np.inf)
        if len(active):
            with np.errstate(divide="ignore"):
                tta = remaining[active] / np.maximum(rates, 1e-9)
            i_min = int(np.argmin(tta))
            nxt_dep = t + tta[i_min]
        else:
            nxt_dep = np.inf
        if nxt_arr == np.inf and nxt_dep == np.inf:
            break
        if until is not None and min(nxt_arr, nxt_dep) > until:
            break
        if nxt_arr <= nxt_dep:  # arrival
            dt = nxt_arr - t
            if len(active):
                remaining[active] -= rates * dt
            t = nxt_arr
            fid = int(order[arrive_ptr])
            arrive_ptr += 1
            active.append(fid)
            rates = recompute()
            if record_events:
                ev_t.append(t); ev_k.append(0); ev_f.append(fid)
        else:  # departure
            dt = nxt_dep - t
            remaining[active] -= rates * dt
            t = nxt_dep
            fid = active.pop(i_min)
            remaining[fid] = 0.0
            fct[fid] = t - flows[fid].t_arrival
            rates = recompute()
            if record_events:
                ev_t.append(t); ev_k.append(1); ev_f.append(fid)

    ideal = np.array([topo.ideal_fct(f.size, f.path) for f in flows])
    return FlowSimResult(
        fcts=fct, slowdowns=fct / ideal,
        event_times=np.array(ev_t), event_types=np.array(ev_k),
        event_fids=np.array(ev_f),
        wallclock=time.perf_counter() - t0)
