"""Closed-loop (dynamic-arrival) execution behind one session protocol.

A copy of `repro.sim.closedloop`. The paper's §5.4 application — per-rack inflight limits where each completion
releases the next request — needs a simulator that consumes arrivals as
they are decided. Every capable backend opens a `ClosedLoopSession`:

    inject_arrival(fid, t)        make flow fid arrive at time t
    next_departure() -> (t, fid)  earliest next completion (None, None if idle)
    commit_departure(fid, t)      finalize it (advances simulator state)
    completion_times() -> array   absolute completion time per flow (NaN open)

and `run_closed_loop` handles the backlog/release logic once for all:

    from repro_torch.sim import get_backend, run_closed_loop
    res = run_closed_loop(get_backend("packet"), topo, config, backlog, 3)
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Optional, Protocol, Tuple

import numpy as np


@dataclass
class ClosedLoopResult:
    completion_times: np.ndarray   # per flow (NaN if never started)
    makespan: float
    throughput: float              # completed flows / sec


class ClosedLoopSession(Protocol):
    def inject_arrival(self, fid: int, t: float) -> None: ...
    def next_departure(self) -> Tuple[Optional[float], Optional[int]]: ...
    def commit_departure(self, fid: int, t: float) -> None: ...
    def completion_times(self) -> np.ndarray: ...


def run_closed_loop(backend, topo, config, backlog: List[list],
                    inflight: int) -> ClosedLoopResult:
    """Drive any backend through the per-rack inflight-limit workload.

    backlog: per-rack ordered flow lists (fids globally unique, contiguous
    from 0). At most `inflight` flows of a rack are in the network; each
    completion releases the rack's next queued flow at the completion time.
    """
    flows = sorted((f for rack in backlog for f in rack), key=lambda f: f.fid)
    session = backend.closed_loop(topo, config, flows)
    queues = [[f.fid for f in rack] for rack in backlog]
    rack_of = {f.fid: r for r, rack in enumerate(backlog) for f in rack}
    ptr = [0] * len(queues)

    def release(r: int, now: float):
        if ptr[r] < len(queues[r]):
            fid = queues[r][ptr[r]]
            ptr[r] += 1
            session.inject_arrival(fid, now)

    for r in range(len(queues)):
        for _ in range(min(inflight, len(queues[r]))):
            release(r, 0.0)

    done, n_total = 0, len(flows)
    while done < n_total:
        t, fid = session.next_departure()
        if fid is None:
            break
        session.commit_departure(fid, t)
        done += 1
        release(rack_of[fid], t)

    ct = session.completion_times()
    mk = float(np.nanmax(ct))
    return ClosedLoopResult(ct, mk, np.isfinite(ct).sum() / mk)


class PacketSession:
    """Ground truth: the incremental DES advanced completion by
    completion. It runs on the host and launches nothing."""

    def __init__(self, topo, config, flows, seed: int = 0):
        from ..net.packetsim import PacketSim
        self.flows = copy.deepcopy(list(flows))
        for f in self.flows:
            f.t_arrival = 0.0
        self.sim = PacketSim(topo, config, seed=seed)
        self.sim.flows = self.flows
        self._pending = None

    def inject_arrival(self, fid: int, t: float):
        self.flows[fid].t_arrival = t
        self.sim._push(t, "arrival", fid)

    def next_departure(self):
        """Advance the event heap until the next flow completes."""
        if self._pending is None:
            self._pending = self.sim.run_until_completion()
        return self._pending

    def commit_departure(self, fid: int, t: float):
        # the DES already committed it while advancing; just consume it
        assert self._pending is not None and self._pending[1] == fid
        self._pending = None

    def completion_times(self):
        return np.array([f.t_done if f.done else np.nan for f in self.flows])


class FlowSimSession:
    """Fluid max-min session: waterfilled rates, linear drain between
    events."""

    def __init__(self, topo, flows):
        self.topo = topo
        self.flows = {f.fid: f for f in flows}
        self.active: List[int] = []
        self.remaining = {}
        self.t = 0.0
        self.ct = np.full(max(self.flows) + 1, np.nan)

    def _rates(self):
        from ..core.flowsim import waterfill
        return waterfill(self.topo.capacity,
                         [np.asarray(self.flows[i].path, np.int64)
                          for i in self.active])

    def _drain(self, t: float):
        if self.active and t > self.t:
            rates = self._rates()
            dt = t - self.t
            for i, fid in enumerate(self.active):
                self.remaining[fid] -= rates[i] * dt
        self.t = t

    def inject_arrival(self, fid: int, t: float):
        self._drain(t)
        self.active.append(fid)
        self.remaining[fid] = self.flows[fid].size * 8.0

    def next_departure(self):
        if not self.active:
            return None, None
        rates = self._rates()
        tta = np.array([self.remaining[i] for i in self.active]) \
            / np.maximum(rates, 1e-9)
        k = int(np.argmin(tta))
        return self.t + float(tta[k]), self.active[k]

    def commit_departure(self, fid: int, t: float):
        self._drain(t)
        self.active.remove(fid)
        self.remaining.pop(fid)
        self.ct[fid] = t

    def completion_times(self):
        return self.ct
