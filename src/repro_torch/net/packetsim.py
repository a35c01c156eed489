"""Reduced packet-level discrete-event simulator: the ns-3 stand-in that
gives m4 its ground truth.

A copy of `repro.net.packetsim` (`PacketSim`, `Trace`, `EventRecord`):
per-link FIFO queues with finite buffers, ECN marking, window-based
congestion control in the DCTCP / DCQCN / TIMELY families, drops and
go-back-N retransmission, and the per-event labels (remaining flow sizes,
first-packet queue lengths, FCTs) that m4's dense supervision trains on
(§3.3, §5.1). It runs on the host in numpy and plain Python, with the
same heap order and the same float arithmetic as the JAX package's copy,
so one scenario and seed give the same `Trace` bit for bit in both.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .config import MTU, Flow, NetConfig
from .topology import FatTree

__all__ = ["EventRecord", "PacketSim", "Trace", "MTU"]


@dataclass
class EventRecord:
    """One flow-level event with its dense ground-truth labels."""
    time: float
    etype: int                 # 0 = arrival, 1 = departure
    fid: int
    active: List[int]          # active flow ids at the event (post-event)
    remaining: List[int]       # remaining bytes of each active flow
    path_queues: List[float]   # arrival only: queue bytes per path link


@dataclass
class Trace:
    topo: FatTree
    config: NetConfig
    flows: List[Flow]
    events: List[EventRecord]

    @property
    def fcts(self):
        return np.array([f.t_done - f.t_arrival for f in self.flows])

    @property
    def slowdowns(self):
        return np.array([
            (f.t_done - f.t_arrival) / self.topo.ideal_fct(f.size, f.path)
            for f in self.flows])


class PacketSim:
    def __init__(self, topo: FatTree, config: NetConfig, seed: int = 0):
        self.topo = topo
        self.cfg = config
        self.rng = np.random.default_rng(seed)
        L = topo.num_links
        self.q_bytes = np.zeros(L)
        self.q: List[List] = [[] for _ in range(L)]   # FIFO of (fid, seq, sz, ecn)
        self.busy = np.zeros(L, dtype=bool)
        self.events: List = []
        self.seq = 0
        self.records: List[EventRecord] = []
        self.flows: List[Flow] = []
        self.active: Dict[int, Flow] = {}
        self._completed_now: int | None = None

    # ---------------------------------------------------------------- events
    def _push(self, t, kind, data):
        heapq.heappush(self.events, (t, self.seq, kind, data))
        self.seq += 1

    def run(self, flows: List[Flow], until: Optional[float] = None) -> Trace:
        return self.run_subset(flows, [f.fid for f in flows], until)

    def run_subset(self, flows: List[Flow], initial_fids,
                   until: Optional[float] = None) -> Trace:
        """Start with only `initial_fids` scheduled; more arrivals may be
        injected while running (closed-loop applications)."""
        self.flows = flows
        for fid in initial_fids:
            self._push(flows[fid].t_arrival, "arrival", fid)
        while self.events:
            t, _, kind, data = heapq.heappop(self.events)
            if until is not None and t > until:
                break
            getattr(self, f"_on_{kind}")(t, data)
        return Trace(self.topo, self.cfg, self.flows, self.records)

    def run_until_completion(self):
        """Advance the event loop until one flow completes.

        Returns (t_done, fid), or (None, None) once the heap drains. This is
        the incremental interface of the closed-loop packet session
        (`repro_torch.sim.closedloop.PacketSession`): `run_closed_loop`
        injects follow-up arrivals between calls.
        """
        self._completed_now = None
        while self.events:
            t, _, kind, data = heapq.heappop(self.events)
            getattr(self, f"_on_{kind}")(t, data)
            if self._completed_now is not None:
                fid = self._completed_now
                self._completed_now = None
                return self.flows[fid].t_done, fid
        return None, None

    # ---------------------------------------------------------------- hooks
    def _record(self, t, etype, fid, path_queues=None):
        act = sorted(self.active.keys())
        self.records.append(EventRecord(
            time=t, etype=etype, fid=fid, active=act,
            remaining=[self.active[a].remaining for a in act],
            path_queues=path_queues or []))

    def _on_arrival(self, t, fid):
        f = self.flows[fid]
        self.active[fid] = f
        f.window = self.cfg.init_window
        f.round_end = int(min(f.size, f.window))
        pq = [float(self.q_bytes[l]) for l in f.path]
        self._record(t, 0, fid, pq)
        self._pump(t, f)

    def _pump(self, t, f: Flow):
        """Send packets while window allows."""
        while (not f.done and f.next_seq < f.size
               and f.next_seq - f.cum_acked + MTU <= max(f.window, MTU)):
            sz = min(MTU, f.size - f.next_seq)
            self._send_pkt(t, f, f.next_seq, sz)
            f.next_seq += sz
        if f.rto_at < 0 and f.cum_acked < f.size:
            rto = max(4 * max(f.srtt, 20e-6), 200e-6)
            f.rto_at = t + rto
            self._push(f.rto_at, "timeout", f.fid)

    def _send_pkt(self, t, f, seq, sz):
        self._push(t, "hop", (f.fid, seq, sz, False, 0))

    def _on_hop(self, t, data):
        """Packet arrives at queue of path[hop]."""
        fid, seq, sz, ecn, hop = data
        f = self.flows[fid]
        if f.done:
            return
        if hop >= len(f.path):        # reached destination -> ack back
            delay = sum(self.topo.prop[l] for l in f.path) + 2e-6
            self._push(t + delay, "ack", (fid, seq, sz, ecn))
            return
        l = f.path[hop]
        if self.q_bytes[l] + sz > self.cfg.buffer_bytes:
            return                    # tail drop -> recovered by RTO
        # ECN marking at enqueue
        q = self.q_bytes[l]
        if self.cfg.cc == "dctcp" and q > self.cfg.dctcp_k:
            ecn = True
        elif self.cfg.cc == "dcqcn":
            kmin, kmax = self.cfg.dcqcn_kmin, self.cfg.dcqcn_kmax
            p = min(max((q - kmin) / max(kmax - kmin, 1.0), 0.0), 1.0)
            if self.rng.random() < p:
                ecn = True
        self.q_bytes[l] += sz
        self.q[l].append((fid, seq, sz, ecn, hop))
        if not self.busy[l]:
            self._serve(t, l)

    def _serve(self, t, l):
        if not self.q[l]:
            self.busy[l] = False
            return
        self.busy[l] = True
        fid, seq, sz, ecn, hop = self.q[l][0]
        tx = sz * 8.0 / self.topo.capacity[l]
        self._push(t + tx, "txdone", l)

    def _on_txdone(self, t, l):
        fid, seq, sz, ecn, hop = self.q[l].pop(0)
        self.q_bytes[l] -= sz
        self._push(t + self.topo.prop[l], "hop", (fid, seq, sz, ecn, hop + 1))
        self._serve(t, l)

    # ---------------------------------------------------------------- acks
    def _on_ack(self, t, data):
        fid, seq, sz, ecn = data
        f = self.flows[fid]
        if f.done:
            return
        if seq == f.cum_acked:
            f.cum_acked = seq + sz
        elif seq > f.cum_acked:
            pass                      # out-of-order: go-back-N ignores
        rtt = t - f.t_arrival if f.srtt == 0 else None
        sample = max(t - (f.rto_at - max(4 * max(f.srtt, 20e-6), 200e-6)), 1e-6) \
            if f.rto_at > 0 else 50e-6
        # estimate RTT from path prop + measured queueing via ack timing:
        base = 2 * sum(self.topo.prop[l] for l in f.path) + 2e-6
        f.prev_rtt = f.srtt if f.srtt > 0 else base
        inst = base + (self.q_bytes[f.path[0]] * 8.0 / self.topo.capacity[f.path[0]]
                       if f.path else 0.0)
        f.srtt = 0.9 * f.srtt + 0.1 * inst if f.srtt > 0 else inst

        self._cc_update(t, f, ecn)

        if f.cum_acked >= f.size:
            self._complete(t, f)
            return
        f.rto_at = -1.0
        self._pump(t, f)

    def _cc_update(self, t, f: Flow, ecn: bool):
        cc = self.cfg.cc
        if cc in ("dctcp", "dcqcn"):
            f.acked_in_round += MTU
            if ecn:
                f.marked += MTU
            if f.cum_acked >= f.round_end:   # one congestion round done
                frac = f.marked / max(f.acked_in_round, 1)
                g = 1 / 16
                f.alpha = (1 - g) * f.alpha + g * frac
                if frac > 0:
                    f.window = max(MTU, f.window * (1 - f.alpha / 2))
                else:
                    f.window += MTU
                f.marked = 0
                f.acked_in_round = 0
                f.round_end = f.cum_acked + int(f.window)
        else:  # timely
            rtt, prev = f.srtt, f.prev_rtt
            if rtt > self.cfg.timely_thigh:
                if t - f.last_md > rtt:
                    f.window = max(MTU, f.window * max(
                        0.5, 1 - 0.8 * (1 - self.cfg.timely_thigh / rtt)))
                    f.last_md = t
            elif rtt < self.cfg.timely_tlow:
                f.window += MTU
            else:
                grad = rtt - prev
                if grad <= 0:
                    f.window += MTU / 2
                elif t - f.last_md > rtt:
                    f.window = max(MTU, f.window * 0.98)
                    f.last_md = t

    def _complete(self, t, f: Flow):
        f.done = True
        f.t_done = t
        self.active.pop(f.fid, None)
        self._record(t, 1, f.fid)
        self._completed_now = f.fid

    def _on_timeout(self, t, fid):
        f = self.flows[fid]
        if f.done or f.rto_at < 0 or t < f.rto_at - 1e-12:
            return
        # go-back-N from last cumulative ack
        f.next_seq = f.cum_acked
        f.window = MTU
        f.rto_at = -1.0
        self._pump(t, f)
