"""Host-side (numpy) preprocessing: Trace -> padded event tensors for the
teacher-forced training loop. All shapes are static: K events, SNAP_F
snapshot flows, SNAP_L snapshot links, P max path length.

A copy of `repro.core.events`: the same fields in the same order and the
same arithmetic, so one `Trace` gives the same `EventBatch` bit for bit in
both packages, and `to_arrays` / `from_arrays` keep the dataset store's
on-disk contract.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from ..net.packetsim import Trace
from .model import M4Config


@dataclass
class EventBatch:
    """One simulation, padded. All numpy; the trainer moves it to its device."""
    # static per-entity
    flow_links: np.ndarray    # (N, P) int32, -1 pad
    flow_feat: np.ndarray     # (N, 3) float32
    link_feat: np.ndarray     # (L, 1) float32
    gt_sldn: np.ndarray       # (N,) float32
    ideal_fct: np.ndarray     # (N,) float32
    t_arrival: np.ndarray     # (N,) float32
    size_bytes: np.ndarray    # (N,) float32
    cfg_vec: np.ndarray       # (C,) float32
    # per-event
    t: np.ndarray             # (K,)
    etype: np.ndarray         # (K,) 0 arrival / 1 departure
    fid: np.ndarray           # (K,)
    snap_f: np.ndarray        # (K, SNAP_F) arena idx, -1 pad; slot0 = event flow
    snap_f_mask: np.ndarray   # (K, SNAP_F)
    snap_l: np.ndarray        # (K, SNAP_L) link ids, -1 pad
    snap_l_mask: np.ndarray   # (K, SNAP_L)
    edge_l: np.ndarray        # (K, SNAP_F*P) local link slot (0 if invalid)
    edge_mask: np.ndarray     # (K, SNAP_F*P)
    gt_remaining: np.ndarray  # (K, SNAP_F) fraction of size
    rem_mask: np.ndarray      # (K, SNAP_F)
    gt_queue: np.ndarray      # (K, SNAP_L) log1p(bytes/1KB)
    queue_mask: np.ndarray    # (K, SNAP_L)

    @property
    def num_flows(self):
        return len(self.flow_links)

    @property
    def num_links(self):
        return len(self.link_feat)

    @property
    def num_events(self):
        return len(self.t)

    @property
    def footprint(self):
        """(N, L, K) sort key used by the training shape-bucketer
        (`repro_torch.train.batching.make_buckets`)."""
        return (self.num_flows, self.num_links, self.num_events)

    def head(self, k: int) -> "EventBatch":
        """The first k events: the per-event arrays (the fields from `t`
        on) cut, the per-flow and per-link ones kept. This is what
        `build_event_batch(trace, cfg, max_events=k)` builds."""
        names = [f.name for f in dataclasses.fields(self)]
        return dataclasses.replace(self, **{
            n: getattr(self, n)[:k] for n in names[names.index("t"):]})

    # -------------------------------------------------- serialization
    # The on-disk contract of the training dataset store
    # (repro_torch.train.data, as repro.train.data): a flat {field: array}
    # dict, nothing clever, so shards survive refactors of this class as
    # long as field names and meanings do.
    def to_arrays(self) -> dict:
        """All fields as a plain {name: np.ndarray} dict."""
        return {k: np.asarray(v) for k, v in self.__dict__.items()}

    @classmethod
    def from_arrays(cls, arrays: dict) -> "EventBatch":
        """Inverse of `to_arrays` (extra keys rejected, missing raise)."""
        names = {f.name for f in cls.__dataclass_fields__.values()}
        extra = set(arrays) - names
        if extra:
            raise KeyError(f"unknown EventBatch fields {sorted(extra)}")
        return cls(**{n: np.asarray(arrays[n]) for n in names})


def build_event_batch(trace: Trace, m4cfg: M4Config,
                      max_events: int | None = None) -> EventBatch:
    topo, flows = trace.topo, trace.flows
    N, L, P = len(flows), topo.num_links, m4cfg.max_path
    SF, SL = m4cfg.snap_flows, m4cfg.snap_links

    flow_links = np.full((N, P), -1, np.int32)
    for f in flows:
        flow_links[f.fid, :len(f.path)] = f.path[:P]
    sizes = np.array([f.size for f in flows], np.float32)
    nlinks = (flow_links >= 0).sum(1).astype(np.float32)
    ideal = np.array([topo.ideal_fct(f.size, f.path) for f in flows], np.float32)
    flow_feat = np.stack([np.log1p(sizes / 1e3) / 10.0, nlinks / 8.0,
                          np.log1p(ideal / 1e-6) / 10.0], -1).astype(np.float32)
    link_feat = (np.log1p(topo.capacity / 1e9) / 10.0)[:, None].astype(np.float32)
    fct = np.array([f.t_done - f.t_arrival if f.done else np.nan for f in flows])
    gt_sldn = (fct / ideal).astype(np.float32)

    # link -> set of flows using it (built incrementally over active sets)
    link_sets = [set(map(int, flow_links[i][flow_links[i] >= 0])) for i in range(N)]

    recs = trace.events if max_events is None else trace.events[:max_events]
    K = len(recs)
    t = np.zeros(K, np.float32)
    etype = np.zeros(K, np.int32)
    fid = np.zeros(K, np.int32)
    snap_f = np.full((K, SF), -1, np.int32)
    snap_l = np.full((K, SL), -1, np.int32)
    edge_l = np.zeros((K, SF * P), np.int32)
    edge_mask = np.zeros((K, SF * P), np.float32)
    gt_rem = np.zeros((K, SF), np.float32)
    rem_mask = np.zeros((K, SF), np.float32)
    gt_queue = np.zeros((K, SL), np.float32)
    queue_mask = np.zeros((K, SL), np.float32)

    for k, r in enumerate(recs):
        t[k], etype[k], fid[k] = r.time, r.etype, r.fid
        ev_links = link_sets[r.fid]
        rem_of = dict(zip(r.active, r.remaining))
        # candidates: active flows (plus the event flow itself)
        cands = [r.fid] + [a for a in r.active
                           if a != r.fid and link_sets[a] & ev_links]
        cands = cands[:SF]
        snap_f[k, :len(cands)] = cands
        # remaining-size labels: post-event remaining fraction
        for i, a in enumerate(cands):
            if a in rem_of:
                gt_rem[k, i] = rem_of[a] / max(sizes[a], 1.0)
                rem_mask[k, i] = 1.0
            elif r.etype == 1 and a == r.fid:
                gt_rem[k, i] = 0.0
                rem_mask[k, i] = 1.0
        # snapshot links = union of candidate paths
        links = sorted(set().union(*[link_sets[a] for a in cands]))[:SL]
        snap_l[k, :len(links)] = links
        pos = {l: j for j, l in enumerate(links)}
        for i, a in enumerate(cands):
            for pth in range(P):
                l = flow_links[a, pth]
                if l >= 0 and int(l) in pos:
                    e = i * P + pth
                    edge_l[k, e] = pos[int(l)]
                    edge_mask[k, e] = 1.0
        # queue labels: first-packet queue per path link (arrival events)
        if r.etype == 0 and r.path_queues:
            for l, q in zip(flows[r.fid].path[:P], r.path_queues[:P]):
                if int(l) in pos:
                    gt_queue[k, pos[int(l)]] = np.log1p(q / 1e3)
                    queue_mask[k, pos[int(l)]] = 1.0

    return EventBatch(
        flow_links=flow_links, flow_feat=flow_feat, link_feat=link_feat,
        gt_sldn=np.nan_to_num(gt_sldn, nan=1.0), ideal_fct=ideal,
        t_arrival=np.array([f.t_arrival for f in flows], np.float32),
        size_bytes=sizes, cfg_vec=trace.config.feature_vec(),
        t=t, etype=etype, fid=fid,
        snap_f=snap_f, snap_f_mask=(snap_f >= 0).astype(np.float32),
        snap_l=snap_l, snap_l_mask=(snap_l >= 0).astype(np.float32),
        edge_l=edge_l, edge_mask=edge_mask,
        gt_remaining=gt_rem, rem_mask=rem_mask,
        gt_queue=gt_queue, queue_mask=queue_mask)
