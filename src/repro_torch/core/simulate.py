"""m4 event-driven open-loop inference (§3.1, Figure 2/5).

The event manager races the next arrival (from the traffic generator)
against the earliest *predicted* departure (from MLP-sldn on the hidden
states). Each event builds a snapshot from the occupancy arenas, advances
GRU-1/GRU-A in time, runs the GNN rounds, refreshes the states with
GRU-2/GRU-B, re-predicts the departures of the snapshot's flows and
scatters the results back; masked snapshot slots write to a dump row.

A port of `repro.core.simulate`'s incremental program. Where JAX runs one
`lax.scan` under `vmap`, the port runs a Python loop of 2·N event steps
over arenas that carry an explicit leading batch axis B (one scenario per
row; `simulate_open_loop` is B = 1), updated in place. No step syncs with
the host: the event pointer, time, flow id and kind stay device tensors,
and every op has a data-independent output shape (`_dedupe_ascending`
replaces `unique`), so the host only enqueues work. Padded flows arrive
at t = BIG after every real event and touch only their own and the dump
rows.
"""
from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from ..nn import mlp
from .model import M4Config, predict_sldn, spatial_update, temporal_update

BIG = 1e30


# ------------------------------------------------------------ host tables
def _membership_tables(flow_links: np.ndarray, num_links: int,
                       k_total=None):
    """link -> flow membership + each flow's slots in it (host-side).

    Returns (link_members (L+1, K): flow ids per link, padded with the dump
    flow id N; occ_rows/occ_slots (N, P): where flow f's path position p
    lives in the table — invalid positions point at the dump row L, slot 0,
    so O(P) occupancy scatters never need a branch). K is the max link
    degree (or `k_total`, to pad a batch to one shape)."""
    N, P = flow_links.shape
    L = num_links
    valid = flow_links >= 0
    counts = np.bincount(flow_links[valid].ravel(), minlength=L) \
        if valid.any() else np.zeros(L, np.int64)
    K = int(max(1, counts.max() if counts.size else 1))
    if k_total is not None:
        if k_total < K:
            raise ValueError(f"k_total={k_total} below the max degree {K}")
        K = int(k_total)
    link_members = np.full((L + 1, K), N, np.int32)
    occ_rows = np.full((N, P), L, np.int32)
    occ_slots = np.zeros((N, P), np.int32)
    fill = np.zeros(L + 1, np.int64)
    for f in range(N):
        for p in range(P):
            l = flow_links[f, p]
            if l < 0:
                continue
            link_members[l, fill[l]] = f
            occ_rows[f, p] = l
            occ_slots[f, p] = fill[l]
            fill[l] += 1
    return link_members, occ_rows, occ_slots


def max_link_degree(flows, max_path: int) -> int:
    """Max number of flows traversing any one link (the K of the
    membership table); batch callers take the max across scenarios."""
    c = Counter()
    for f in flows:
        for l in f.path[:max_path]:
            c[l] += 1
    return max(c.values(), default=1)


def make_static(topo, flows, net_config, cfg: M4Config, n_total=None,
                l_total=None, k_total=None):
    """Arena constants for one scenario, as numpy arrays. `n_total`/
    `l_total`/`k_total` pad the flow, link and membership axes to a shared
    shape so scenarios can be stacked: padded flows have no links and
    arrive at t=BIG, padded links are on no path."""
    P = cfg.max_path
    n = len(flows)
    N = n if n_total is None else n_total
    L = topo.num_links if l_total is None else l_total
    if N < n or L < topo.num_links:
        raise ValueError("padding below the scenario's own size")
    flow_links = np.full((N, P), -1, np.int32)
    for f in flows:
        flow_links[f.fid, :len(f.path)] = f.path[:P]
    sizes = np.zeros(N, np.float32)
    sizes[:n] = [f.size for f in flows]
    nlinks = (flow_links >= 0).sum(1).astype(np.float32)
    ideal = np.full(N, 1e-9, np.float32)
    ideal[:n] = [topo.ideal_fct(f.size, f.path) for f in flows]
    t_arrival = np.full(N, BIG, np.float32)
    t_arrival[:n] = [f.t_arrival for f in flows]
    flow_feat = np.stack([np.log1p(sizes / 1e3) / 10.0, nlinks / 8.0,
                          np.log1p(ideal / 1e-6) / 10.0], -1)
    cap = np.full(L, topo.capacity.max(), np.float64)
    cap[:topo.num_links] = topo.capacity
    link_members, occ_rows, occ_slots = _membership_tables(
        flow_links, L, k_total)
    return {
        "flow_links": flow_links,
        "flow_feat": flow_feat.astype(np.float32),
        "link_feat": (np.log1p(cap / 1e9)[:, None] / 10.0).astype(np.float32),
        "ideal_fct": ideal,
        "t_arrival": t_arrival,
        "cfg_vec": net_config.feature_vec(),
        "link_members": link_members,
        "occ_rows": occ_rows,
        "occ_slots": occ_slots,
    }, L, ideal


def _arrival_order(static):
    """Stable arrival order over the (possibly padded) arena; padded flows
    sit at t=BIG and therefore sort last."""
    t = np.asarray(static["t_arrival"])
    order = np.argsort(t, kind="stable").astype(np.int32)
    return order, t[order].astype(np.float32)


def stack_static(statics, device) -> dict:
    """Stack per-scenario numpy tables into (B, ...) device tensors; index
    tables become int64, the index type of torch's gathers and scatters."""
    out = {}
    for k in statics[0]:
        t = torch.from_numpy(np.stack([s[k] for s in statics]))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


# ------------------------------------------------------------ snapshots
def _dedupe_ascending(vals, k: int, sentinel: int):
    """First k distinct values of each row of `vals` (B, M) in ascending
    order, padded with `sentinel` (which upper-bounds every real value):
    `unique(size=k, fill_value=sentinel)` per row, with a fixed output
    shape. One sort, then first-occurrence compaction by a cumsum-indexed
    scatter-min: duplicates share their first occurrence's slot and value;
    overflow past k slots clips onto slot k-1, where the min keeps the
    true k-th distinct value."""
    s, _ = torch.sort(vals, dim=-1)
    first = torch.ones_like(s, dtype=torch.bool)
    first[..., 1:] = s[..., 1:] != s[..., :-1]
    slot = (torch.cumsum(first, -1) - 1).clamp(max=k - 1)
    out = torch.full((*s.shape[:-1], k), sentinel, dtype=s.dtype,
                     device=s.device)
    return out.scatter_reduce(-1, slot, s, reduce="amin", include_self=True)


def _build_snapshot_dense(cfg: M4Config, flow_links, fid, active_mask):
    """Test oracle: affected flows = active flows sharing >= 1 link with
    the event flow, by a dense (B, N, P, P) comparison + top-k over the
    whole arena. `_build_snapshot` must emit the same."""
    SF = cfg.snap_flows
    B, N, _ = flow_links.shape
    b1 = torch.arange(B, device=flow_links.device)
    ev_links = flow_links[b1, fid]                            # (B, P)
    share = (flow_links[:, :, :, None] == ev_links[:, None, None, :]) \
        & (flow_links[:, :, :, None] >= 0)
    shares = share.any(3).any(2)                              # (B, N)
    score = torch.where(shares & active_mask, 1.0, 0.0)
    score[b1, fid] = -1.0
    # stable top-(SF-1) by score (ties -> lower index)
    key = score * N - torch.arange(N, device=score.device)
    k = min(SF - 1, N)
    idx = torch.topk(key, k, dim=1).indices
    valid = torch.gather(score, 1, idx) > 0
    pad = SF - 1 - k
    if pad:
        idx = torch.cat([idx, idx.new_zeros(B, pad)], 1)
        valid = torch.cat([valid, valid.new_zeros(B, pad)], 1)
    idx = torch.where(valid, idx, N)
    snap_f = torch.cat([fid[:, None], idx], 1)
    snap_mask = torch.cat([torch.ones(B, 1, device=score.device),
                           valid.float()], 1)
    return snap_f, snap_mask


def _build_snapshot(cfg: M4Config, static, link_occ, fid):
    """Incremental snapshot builder: candidates come from the membership
    lists of the event flow's <= P links, filtered by the occupancy
    bitmap. Slot 0 = event flow, then the lowest-index active sharing flows
    ascending, dump index N beyond."""
    B, N = static["flow_links"].shape[:2]
    b2 = torch.arange(B, device=fid.device)[:, None]
    rows = static["occ_rows"][b2[:, 0], fid]                  # (B, P)
    cand = static["link_members"][b2, rows]                   # (B, P, K)
    occ = link_occ[b2, rows]                                  # (B, P, K)
    vals = torch.where(occ & (cand != fid[:, None, None]), cand, N)
    uniq = _dedupe_ascending(vals.reshape(B, -1), cfg.snap_flows - 1, N)
    snap_f = torch.cat([fid[:, None], uniq], 1)
    snap_mask = torch.cat([torch.ones(B, 1, device=fid.device),
                           (uniq < N).float()], 1)
    return snap_f, snap_mask


def _build_links(cfg: M4Config, flow_links, snap_f, snap_f_mask,
                 num_links: int):
    """Snapshot link set (deduped, padded) + edge list, all snapshot-sized
    (SF·P). Edges are flow-slot major: edge e belongs to flow slot e // P."""
    B = flow_links.shape[0]
    b2 = torch.arange(B, device=snap_f.device)[:, None]
    gl = flow_links[b2, snap_f]                               # (B, SF, P)
    gl = torch.where((gl >= 0) & (snap_f_mask[..., None] > 0), gl,
                     num_links).reshape(B, -1)
    snap_l = _dedupe_ascending(gl, cfg.snap_links, num_links)
    snap_l_mask = (snap_l < num_links).float()
    el = torch.searchsorted(snap_l, gl)
    edge_mask = (gl < num_links).float()
    el = torch.where(edge_mask > 0, el.clamp(max=cfg.snap_links - 1), 0)
    return snap_l, snap_l_mask, el, edge_mask


# ------------------------------------------------------------ event step
def make_event_step(cfg: M4Config, static, num_links: int):
    """static: dict of (B, ...) arena constant tensors (flow_links,
    flow_feat, link_feat, ideal_fct, t_arrival, cfg_vec, link_members,
    occ_rows, occ_slots)."""
    SF, P = cfg.snap_flows, cfg.max_path
    B, N = static["flow_links"].shape[:2]
    dev = static["flow_links"].device
    b1 = torch.arange(B, device=dev)
    b2 = b1[:, None]
    edge_f = torch.arange(SF, device=dev).repeat_interleave(P)   # (SF·P,)

    def event_step(params, state, t_ev, fid, is_arrival):
        """One flow-level event per scenario (t_ev, fid, is_arrival: (B,)).
        Updates `state` in place; returns (state, sldn, snapshot)."""
        flow_links, cfg_vec = static["flow_links"], static["cfg_vec"]
        snap_f, sfm = _build_snapshot(cfg, static, state["link_occ"], fid)
        # occupancy arenas: the event flow enters (arrival) / leaves
        # (departure) the membership slots of its own links — O(P)
        state["link_occ"][b2, static["occ_rows"][b1, fid],
                          static["occ_slots"][b1, fid]] = \
            is_arrival[:, None].expand(B, P)
        fgather = snap_f.clamp(max=N - 1)   # clamped gathers (masked out)
        snap_l, slm, edge_l, edge_mask = _build_links(
            cfg, flow_links, fgather, sfm, num_links)
        sl_safe = snap_l.clamp(max=num_links)  # dump row = num_links
        lgather = snap_l.clamp(max=num_links - 1)

        f_h = state["flow_h"][b2, snap_f]
        l_h = state["link_h"][b2, sl_safe]
        f_feat = static["flow_feat"][b2, fgather]
        l_feat = static["link_feat"][b2, lgather]

        # arrival: init slot-0 hidden state from static features (§3.2.1)
        fin = torch.cat([static["flow_feat"][b1, fid], cfg_vec], -1)
        h_new = torch.tanh(mlp(params["flow_init"], fin))
        f_h[:, 0] = torch.where(is_arrival[:, None], h_new, f_h[:, 0])

        dt_f = t_ev[:, None] - state["flow_last"][b2, snap_f]
        dt_f[:, 0] = torch.where(is_arrival, 0.0, dt_f[:, 0])
        dt_l = t_ev[:, None] - state["link_last"][b2, sl_safe]

        f_h, l_h = temporal_update(params, cfg, f_h, l_h, dt_f, dt_l,
                                   f_feat, l_feat, cfg_vec)
        f_h2, l_h2 = spatial_update(params, cfg, f_h, l_h, edge_f, edge_l,
                                    edge_mask, cfg_vec)
        sldn = predict_sldn(params, f_h2,
                            static["flow_feat"][b2, fgather, 1] * 8.0,
                            cfg_vec)

        # departure-time re-prediction for snapshot flows
        t_dep_new = state["t_arr"][b2, snap_f] \
            + sldn * static["ideal_fct"][b2, fgather]
        t_dep_new = torch.maximum(t_dep_new, (t_ev + 1e-9)[:, None])

        # scatter back with masked slots redirected to the dump row (index
        # N / num_links): live rows receive exactly f_h2/l_h2, the dump row
        # absorbs the rest (in no fixed order — it is never read back)
        idx_f = torch.where(sfm > 0, snap_f, N)
        idx_l = torch.where(slm > 0, sl_safe, num_links)
        state["flow_h"][b2, idx_f] = f_h2
        state["link_h"][b2, idx_l] = l_h2
        state["flow_last"][b2, idx_f] = t_ev[:, None].expand(B, SF)
        state["link_last"][b2, idx_l] = t_ev[:, None].expand_as(idx_l)
        state["t_dep"][b2, idx_f] = t_dep_new
        snap = {"snap_f": snap_f, "snap_mask": sfm, "snap_l": snap_l,
                "snap_l_mask": slm, "edge_l": edge_l, "edge_mask": edge_mask}
        return state, sldn, snap

    return event_step


def init_sim_state(params, cfg: M4Config, static, N: int, num_links: int):
    """(B, ...) arenas with one extra 'dump' row (index N / num_links)
    that absorbs scatters from masked snapshot slots. `link_occ` mirrors
    the static `link_members` table: occ[b, l, k] == flow
    link_members[b, l, k] is active."""
    H = params["gru1"]["wh"].shape[0]
    L = num_links
    B, _, K = static["link_members"].shape
    dev = static["flow_links"].device
    f32 = {"dtype": torch.float32, "device": dev}
    l_in = torch.cat([static["link_feat"][:, :L],
                      static["cfg_vec"][:, None].expand(B, L, -1)], -1)
    link_h = torch.tanh(mlp(params["link_init"], l_in))
    link_h = torch.cat([link_h, torch.zeros(B, 1, H, **f32)], 1)
    return dict(
        flow_h=torch.zeros(B, N + 1, H, **f32),
        link_h=link_h,
        flow_last=torch.zeros(B, N + 1, **f32),
        link_last=torch.zeros(B, L + 1, **f32),
        arrived=torch.zeros(B, N + 1, dtype=torch.bool, device=dev),
        done=torch.zeros(B, N + 1, dtype=torch.bool, device=dev),
        link_occ=torch.zeros(B, L + 1, K, dtype=torch.bool, device=dev),
        t_dep=torch.full((B, N + 1), BIG, **f32),
        fct=torch.zeros(B, N + 1, **f32),
        t_arr=torch.cat([static["t_arrival"], torch.zeros(B, 1, **f32)], 1))


# ------------------------------------------------------------ open loop
def _open_loop_body(params, step, state, ptr, arr_order, arr_times):
    """Race the next arrival against the earliest predicted departure and
    process that event, for every scenario. Returns (state, ptr, t_ev,
    fid, is_arr, snapshot), all device tensors."""
    B, N = arr_times.shape
    b1 = torch.arange(B, device=ptr.device)
    pc = ptr.clamp(max=N - 1)[:, None]
    next_arr = torch.where(ptr < N, arr_times.gather(1, pc)[:, 0], BIG)
    # invariant: t_dep rows < N are finite exactly for flows that are
    # arrived-and-not-done, so the race reads the arena directly
    dep_t = state["t_dep"][:, :N]
    dep_i = dep_t.argmin(1)                    # first index on ties
    next_dep = dep_t.gather(1, dep_i[:, None])[:, 0]
    is_arr = next_arr <= next_dep              # arrivals win ties
    t_ev = torch.where(is_arr, next_arr, next_dep)
    fid = torch.where(is_arr, arr_order.gather(1, pc)[:, 0], dep_i)

    state, _, snap = step(params, state, t_ev, fid, is_arr)
    # every event at fid implies "arrived"; "done" iff departure; the
    # arrival event's fct / t_dep writes go to the dump row
    fid_or_dump = torch.where(is_arr, N, fid)
    state["arrived"][b1, fid] = True
    state["done"][b1, fid] = ~is_arr
    state["fct"][b1, fid_or_dump] = t_ev - state["t_arr"][b1, fid]
    state["t_dep"][b1, fid_or_dump] = BIG
    return state, ptr + is_arr.long(), t_ev, fid, is_arr, snap


@torch.inference_mode()
def _open_loop_core(params, cfg: M4Config, num_links: int, static,
                    arr_order, arr_times):
    """2·N events over (B, N) arenas; returns (fct, done), both (B, N)."""
    B, N = arr_times.shape
    step = make_event_step(cfg, static, num_links)
    state = init_sim_state(params, cfg, static, N, num_links)
    ptr = torch.zeros(B, dtype=torch.long, device=arr_times.device)
    for _ in range(2 * N):
        state, ptr, *_ = _open_loop_body(params, step, state, ptr,
                                         arr_order, arr_times)
    return state["fct"][:, :N], state["done"][:, :N]


@dataclass
class M4Result:
    fcts: np.ndarray
    slowdowns: np.ndarray
    wallclock: float          # enqueue + device execution, synchronised


def _device(params) -> torch.device:
    return params["gru1"]["wi"].device


def simulate_open_loop(params, cfg: M4Config, topo, net_config,
                       flows) -> M4Result:
    """One scenario through the open loop, on the device of `params`."""
    return simulate_open_loop_batch(params, cfg,
                                    [(topo, net_config, flows)])[0]


def simulate_open_loop_batch(params, cfg: M4Config, scenarios) -> list:
    """Run many scenarios as one batch of arenas.

    scenarios: sequence of (topo, net_config, flows). Arenas are padded to
    the largest flow/link/degree count in the batch; padded work is dead
    weight in exchange for one event loop whose every op covers all
    scenarios."""
    scenarios = list(scenarios)
    if not scenarios:
        return []
    device = _device(params)
    n_max = max(len(flows) for _, _, flows in scenarios)
    l_max = max(topo.num_links for topo, _, _ in scenarios)
    k_max = max(max_link_degree(flows, cfg.max_path)
                for _, _, flows in scenarios)
    statics, orders, times, ideals, counts = [], [], [], [], []
    for topo, net_config, flows in scenarios:
        static, _, ideal = make_static(topo, flows, net_config, cfg,
                                       n_total=n_max, l_total=l_max,
                                       k_total=k_max)
        order, t = _arrival_order(static)
        statics.append(static)
        orders.append(order)
        times.append(t)
        ideals.append(ideal)
        counts.append(len(flows))
    static = stack_static(statics, device)
    order_b = torch.from_numpy(np.stack(orders)).long().to(device)
    times_b = torch.from_numpy(np.stack(times)).to(device)
    t0 = time.perf_counter()
    fct, _ = _open_loop_core(params, cfg, l_max, static, order_b, times_b)
    fct = fct.cpu().numpy()
    wall = time.perf_counter() - t0
    return [M4Result(fcts=fct[b, :n], slowdowns=fct[b, :n] / ideals[b][:n],
                     wallclock=wall / len(scenarios))
            for b, n in enumerate(counts)]
