"""m4 event-driven open-loop inference (§3.1, Figure 2/5).

The event manager races the next arrival (from the traffic generator)
against the earliest *predicted* departure (from MLP-sldn on the hidden
states). Each event builds a snapshot from the occupancy arenas, advances
GRU-1/GRU-A in time, runs the GNN rounds, refreshes the states with
GRU-2/GRU-B, re-predicts the departures of the snapshot's flows and
scatters the results back; masked snapshot slots write to a dump row.

A port of `repro.core.simulate`. Where JAX runs one `lax.scan` under
`vmap` and `jax.jit`, the port runs 2·N event steps over arenas that
carry an explicit leading batch axis B (one scenario per row;
`simulate_open_loop` is B = 1), updated in place, as one program of
`repro_torch.core.compiled` per arena shape: on a card one event step
captured as a CUDA graph and replayed 2·N times, on the CPU the same step
run eagerly. Each new program counts one in `TRACE_COUNTS` under the JAX
package's names ("open_loop" for `simulate_open_loop`,
"open_loop_batched" for `simulate_open_loop_batch`). No step syncs with
the host: the event pointer, time, flow id and kind stay device tensors,
and every op has a data-independent output shape (`_dedupe_ascending`
replaces `unique`). Padded flows arrive at t = BIG after every real
event and touch only their own and the dump rows.

`snapshot_impl` selects the event-step program, as in the JAX package:
"incremental" (the snapshot from the occupancy arenas, dump-row
scatter-back, the kernels through `kernels.dispatch`) or "dense" (the
seed program that JAX's perf gate measures against: the O(N·P²) dense
candidate search, blend-style scatter-back, and the plain GRU cells and
GNN on any device).

`probes=` records m4's belief about intermediate state (predicted queue
per link, active flows per link, predicted remaining bytes per flow)
every `stride` events into ring buffers on the device
(`repro_torch.core.probes`); with probes off the loop is unchanged.
"""
from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import dispatch
from ..nn import mlp
from ..weights import tree_map
from . import compiled
from . import probes as _probes
from .model import (M4Config, predict_queue, predict_size, predict_sldn,
                    spatial_update, temporal_update)
from .probes import M4_CHANNELS, ProbeConfig, normalize_probes

BIG = 1e30

# New compiled programs per entry point ("open_loop", "open_loop_batched"):
# one per key of `repro_torch.core.compiled`, where the JAX package counts
# its XLA traces under the same names.
TRACE_COUNTS = Counter()


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
    score[b1, fid] = score.new_full((B,), -1.0)
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
def make_event_step(cfg: M4Config, static, num_links: int,
                    snapshot_impl: str = "incremental"):
    """static: dict of (B, ...) arena constant tensors (flow_links,
    flow_feat, link_feat, ideal_fct, t_arrival, cfg_vec, link_members,
    occ_rows, occ_slots). `snapshot_impl` "incremental" or "dense" (see
    the module docstring)."""
    if snapshot_impl not in ("incremental", "dense"):
        raise ValueError(f"snapshot_impl {snapshot_impl!r}: "
                         "'incremental' or 'dense'")
    legacy = snapshot_impl == "dense"
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
        if legacy:
            active = (state["arrived"] & ~state["done"])[:, :N].clone()
            # the arriving flow counts (device values throughout: a
            # host scalar would be a host-to-device copy, which a graph
            # capture refuses)
            active[b1, fid] = torch.ones_like(is_arrival)
            snap_f, sfm = _build_snapshot_dense(cfg, flow_links, fid,
                                                active)
        else:
            snap_f, sfm = _build_snapshot(cfg, static, state["link_occ"],
                                          fid)
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
                                   f_feat, l_feat, cfg_vec, plain=legacy)
        f_h2, l_h2 = spatial_update(params, cfg, f_h, l_h, edge_f, edge_l,
                                    edge_mask, cfg_vec, plain=legacy)
        sldn = predict_sldn(params, f_h2,
                            static["flow_feat"][b2, fgather, 1] * 8.0,
                            cfg_vec)

        # departure-time re-prediction for snapshot flows
        t_dep_new = state["t_arr"][b2, snap_f] \
            + sldn * static["ideal_fct"][b2, fgather]
        t_dep_new = torch.maximum(t_dep_new, (t_ev + 1e-9)[:, None])

        if legacy:
            # the seed's blend scatter: read-modify-write of the arenas
            wf, wl = sfm[..., None], slm[..., None]
            t_b = t_ev[:, None]
            state["flow_h"][b2, snap_f] = \
                wf * f_h2 + (1 - wf) * state["flow_h"][b2, snap_f]
            state["link_h"][b2, sl_safe] = \
                wl * l_h2 + (1 - wl) * state["link_h"][b2, sl_safe]
            state["flow_last"][b2, snap_f] = torch.where(
                sfm > 0, t_b, state["flow_last"][b2, snap_f])
            state["link_last"][b2, sl_safe] = torch.where(
                slm > 0, t_b, state["link_last"][b2, sl_safe])
            state["t_dep"][b2, snap_f] = torch.where(
                sfm > 0, t_dep_new, state["t_dep"][b2, snap_f])
        else:
            # scatter back with masked slots redirected to the dump row
            # (index N / num_links): live rows receive exactly f_h2/l_h2,
            # the dump row absorbs the rest (in no fixed order — it is
            # never read back)
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
    b8 = {"dtype": torch.bool, "device": dev}
    state = dict(
        flow_h=torch.empty(B, N + 1, H, **f32),
        link_h=torch.empty(B, L + 1, H, **f32),
        flow_last=torch.empty(B, N + 1, **f32),
        link_last=torch.empty(B, L + 1, **f32),
        arrived=torch.empty(B, N + 1, **b8), done=torch.empty(B, N + 1, **b8),
        link_occ=torch.empty(B, L + 1, K, **b8),
        t_dep=torch.empty(B, N + 1, **f32), fct=torch.empty(B, N + 1, **f32),
        t_arr=torch.empty(B, N + 1, **f32))
    reset_sim_state(state, params, static, num_links)
    return state


def reset_sim_state(state, params, static, num_links: int) -> None:
    """Fill the arenas of `init_sim_state` in place: every link's hidden
    state from its static features, everything else empty."""
    L = num_links
    B, n1 = state["t_arr"].shape
    l_in = torch.cat([static["link_feat"][:, :L],
                      static["cfg_vec"][:, None].expand(B, L, -1)], -1)
    state["link_h"][:, :L] = torch.tanh(mlp(params["link_init"], l_in))
    state["link_h"][:, L] = 0.0
    for k in ("flow_h", "flow_last", "link_last", "arrived", "done",
              "link_occ", "fct"):
        state[k].zero_()
    state["t_dep"].fill_(BIG)
    state["t_arr"][:, :n1 - 1] = static["t_arrival"]
    state["t_arr"][:, n1 - 1] = 0.0


# ------------------------------------------------------------ open loop
def _open_loop_body(params, step, state, ptr, arr_order, arr_times,
                    legacy: bool = False):
    """Race the next arrival against the earliest predicted departure and
    process that event, for every scenario; `ptr` (B,) advances in place.
    Returns (state, ptr, t_ev, fid, is_arr, snapshot), all device tensors.
    `legacy` runs the dense program's race and updates."""
    B, N = arr_times.shape
    b1 = torch.arange(B, device=ptr.device)
    pc = ptr.clamp(max=N - 1)[:, None]
    next_arr = torch.where(ptr < N, arr_times.gather(1, pc)[:, 0], BIG)
    if legacy:
        dep_t = torch.where(state["arrived"] & ~state["done"],
                            state["t_dep"], BIG)[:, :N]
    else:
        # invariant: t_dep rows < N are finite exactly for flows that are
        # arrived-and-not-done, so the race reads the arena directly
        dep_t = state["t_dep"][:, :N]
    dep_i = dep_t.argmin(1)                    # first index on ties
    next_dep = dep_t.gather(1, dep_i[:, None])[:, 0]
    is_arr = next_arr <= next_dep              # arrivals win ties
    t_ev = torch.where(is_arr, next_arr, next_dep)
    fid = torch.where(is_arr, arr_order.gather(1, pc)[:, 0], dep_i)

    state, _, snap = step(params, state, t_ev, fid, is_arr)
    if legacy:
        state["arrived"][b1, fid] = state["arrived"][b1, fid] | is_arr
        state["done"][b1, fid] = state["done"][b1, fid] | ~is_arr
        state["fct"][b1, fid] = torch.where(
            is_arr, state["fct"][b1, fid], t_ev - state["t_arr"][b1, fid])
        state["t_dep"][b1, fid] = torch.where(
            is_arr, state["t_dep"][b1, fid], BIG)
    else:
        # every event at fid implies "arrived"; "done" iff departure; the
        # arrival event's fct / t_dep writes go to the dump row
        fid_or_dump = torch.where(is_arr, N, fid)
        state["arrived"][b1, fid] = torch.ones_like(is_arr)
        state["done"][b1, fid] = ~is_arr
        state["fct"][b1, fid_or_dump] = t_ev - state["t_arr"][b1, fid]
        state["t_dep"][b1, fid_or_dump] = torch.full_like(t_ev, BIG)
    ptr.add_(is_arr.long())
    return state, ptr, t_ev, fid, is_arr, snap


def _probe_values(params, static, state, N: int, num_links: int):
    """Channel read-out thunks over the post-event arenas: the simulator's
    *belief* about intermediate network state (the quantities the paper
    densely supervises), (B, D) each. Called only on stride hits."""

    def active():
        return (state["arrived"] & ~state["done"])[:, :N].float()

    def link_queue():
        # MLP-queue head over every live link hidden state (log1p(KB)
        # scale; the host-side finalize converts to bytes)
        return predict_queue(params, state["link_h"][:, :num_links])

    def link_active():
        # active-flow count per link through the static path->slot table;
        # invalid path slots scatter onto the dump row
        rows = static["occ_rows"]                              # (B, N, P)
        B = rows.shape[0]
        src = active()[:, :, None].expand(rows.shape)
        cnt = torch.zeros(B, num_links + 1, device=rows.device)
        cnt.scatter_add_(1, rows.reshape(B, -1), src.reshape(B, -1))
        return cnt[:, :num_links]

    def flow_remaining():
        # MLP-size head: remaining *fraction*, zeroed outside a flow's
        # lifetime so the series reads as size -> 0 over the flow's life
        return predict_size(params, state["flow_h"][:, :N]) * active()

    return {"link_queue": link_queue, "link_active": link_active,
            "flow_remaining": flow_remaining}


def _m4_program(params, cfg: M4Config, num_links: int, static, arr_order,
                arr_times, probes, snapshot_impl, length) -> compiled.Program:
    """The open loop's program for arenas shaped like these: its own
    copies of the weights, arenas and schedule, the carried state, and
    one event step over them (with `probes`, also the rings, their hit
    counter and the read-out)."""
    B, N = arr_times.shape
    p = tree_map(torch.clone, params)
    st = {k: v.clone() for k, v in static.items()}
    order, times = arr_order.clone(), arr_times.clone()
    state = init_sim_state(p, cfg, st, N, num_links)
    ptr = torch.zeros(B, dtype=torch.long, device=times.device)
    step = make_event_step(cfg, st, num_links, snapshot_impl)
    legacy = snapshot_impl == "dense"
    owned = [*state.values(), *st.values(), order, times, ptr]
    bufs = hits = sample = None
    if probes is not None:
        bufs = _probes.init_buffers(probes, batch=B, num_flows=N,
                                    num_links=num_links,
                                    device=times.device)
        hits = torch.zeros((), dtype=torch.long, device=times.device)
        owned += [*bufs.values(), hits]
        # the read-outs see each event's post-event arenas in place
        vals = _probe_values(p, st, state, N, num_links)

        def sample(t_ev):
            _probes.record(probes, bufs, hits, t_ev, vals)

    def load(params, static, arr_order, arr_times):
        tree_map(lambda d, x: d.copy_(x), p, params)
        for k, v in static.items():
            st[k].copy_(v)
        order.copy_(arr_order)
        times.copy_(arr_times)
        reset_sim_state(state, p, st, num_links)
        ptr.zero_()
        if bufs is not None:
            _probes.reset_buffers(bufs)
            hits.zero_()

    def event():
        return _open_loop_body(p, step, state, ptr, order, times,
                               legacy)[2]

    def result():
        out = (state["fct"][:, :N].clone(), state["done"][:, :N].clone())
        if bufs is not None:
            out += ({k: v.clone() for k, v in bufs.items()},)
        return out

    return compiled.Program(load=load, event=event, sample=sample,
                            stride=None if probes is None else probes.stride,
                            length=length, result=result, buffers=owned)


def _open_loop_core(params, cfg: M4Config, num_links: int, static,
                    arr_order, arr_times, probes: ProbeConfig = None, *,
                    snapshot_impl: str = "incremental", num_events=None,
                    entry: str = "open_loop_batched"):
    """2·N events (or `num_events`) over (B, N) arenas, through entry
    point `entry`'s compiled program for this key; returns (fct, done),
    both (B, N), and with `probes` also the ring buffers (see
    `core.probes`)."""
    B, N = arr_times.shape
    K = static["link_members"].shape[2]
    length = 2 * N if num_events is None else num_events
    key = (cfg, num_links, B, N, K, snapshot_impl, num_events, probes)

    def build(params, static, arr_order, arr_times):
        return _m4_program(params, cfg, num_links, static, arr_order,
                           arr_times, probes, snapshot_impl, length)
    return compiled.run(TRACE_COUNTS, entry, key, arr_times.device, build,
                        params, static, arr_order, arr_times)


@dataclass
class M4Result:
    fcts: np.ndarray
    slowdowns: np.ndarray
    wallclock: float          # enqueue + device execution, synchronised
    # wall time of the cold first call (the program's capture on a card,
    # its build on the CPU, and a run); 0.0 unless `warmup` split the two
    compile_wall: float = 0.0
    # finalized `repro.obs.timeseries/1` dict when a ProbeConfig was passed
    probes: object = None


def _finalize_m4_series(probes, bufs, flows, *, num_flows, num_links,
                        trim_links=None):
    """Host-side unit conversion of one scenario's raw m4 probe ring:
    remaining fraction x flow size -> bytes, MLP-queue log1p(KB) head ->
    bytes."""
    series = _probes.finalize(probes, bufs, num_flows=num_flows,
                              num_links=num_links, trim_flows=len(flows),
                              trim_links=trim_links)
    ch = series["channels"]
    if "flow_remaining" in ch:
        sizes = np.array([f.size for f in flows], np.float64)
        ch["flow_remaining"] = ch["flow_remaining"] * sizes[None, :]
    if "link_queue" in ch:
        ch["link_queue"] = np.expm1(np.maximum(ch["link_queue"], 0.0)) * 1e3
    series["meta"] = {"backend": "m4",
                      "units": {"link_queue": "bytes",
                                "link_active": "flows",
                                "flow_remaining": "bytes"}}
    return series


def _device(params) -> torch.device:
    return params["gru1"]["wi"].device


def simulate_open_loop(params, cfg: M4Config, topo, net_config, flows, *,
                       warmup=False, snapshot_impl="incremental",
                       probes: ProbeConfig = None) -> M4Result:
    """One scenario through the open loop, on the device of `params`.

    `warmup=True` runs the loop twice and reports the cold first call
    (the program's capture and a run) as `M4Result.compile_wall`, keeping
    `wallclock` the second call's. `snapshot_impl="dense"` runs the seed
    program (comparisons only). `probes` also records intermediate-state
    time series into `M4Result.probes`; None runs the unprobed loop."""
    return _run_open_loop(params, cfg, [(topo, net_config, flows)],
                          entry="open_loop", warmup=warmup,
                          snapshot_impl=snapshot_impl, probes=probes)[0]


def simulate_open_loop_batch(params, cfg: M4Config, scenarios, *,
                             snapshot_impl="incremental",
                             probes: ProbeConfig = None) -> list:
    """Run many scenarios as one batch of arenas.

    scenarios: sequence of (topo, net_config, flows). Arenas are padded to
    the largest flow/link/degree count in the batch; padded work is dead
    weight in exchange for one compiled program whose every op covers all
    scenarios. `probes` records per-scenario series (batched ring
    buffers, sliced and trimmed to each scenario's flows and links on the
    host)."""
    return _run_open_loop(params, cfg, scenarios, entry="open_loop_batched",
                          snapshot_impl=snapshot_impl, probes=probes)


def _run_open_loop(params, cfg: M4Config, scenarios, *, entry: str,
                   warmup=False, snapshot_impl="incremental",
                   probes: ProbeConfig = None) -> list:
    probes = normalize_probes(probes, M4_CHANNELS)
    scenarios = list(scenarios)
    if not scenarios:
        return []
    device = _device(params)
    dispatch.count_dispatch(device, plain=snapshot_impl == "dense")
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

    def call():
        t0 = time.perf_counter()
        out = _open_loop_core(params, cfg, l_max, static, order_b, times_b,
                              probes, snapshot_impl=snapshot_impl,
                              entry=entry)
        fct = out[0].cpu().numpy()
        bufs = None if probes is None else _probes.buffers_numpy(out[2])
        return fct, bufs, time.perf_counter() - t0

    compile_wall = call()[2] if warmup else 0.0
    fct, bufs, wall = call()
    results = []
    for b, n in enumerate(counts):
        series = None
        if bufs is not None:
            topo_b, _, flows_b = scenarios[b]
            series = _finalize_m4_series(
                probes, {k: v[b] for k, v in bufs.items()}, flows_b,
                num_flows=n_max, num_links=l_max,
                trim_links=topo_b.num_links)
        results.append(M4Result(fcts=fct[b, :n],
                                slowdowns=fct[b, :n] / ideals[b][:n],
                                wallclock=wall / len(scenarios),
                                compile_wall=compile_wall,
                                probes=series))
    return results


# ------------------------------------------------------------ closed loop
class M4Simulator:
    """Single-event interface for closed-loop traffic generators (§5.4),
    the `repro_torch.sim` closed-loop session of the `m4` backend.

    The flow arena is pre-sized to the full backlog; `run_closed_loop`
    releases arrivals dynamically. Arenas are a batch of one, updated in
    place by the open loop's `make_event_step`. `next_departure` is a
    masked argmin on the device that brings two scalars to the host: one
    sync per call, none per event step."""

    def __init__(self, params, cfg: M4Config, topo, net_config, flows):
        self.params, self.cfg = params, cfg
        self.device = _device(params)
        static, self.num_links, self.ideal = make_static(
            topo, flows, net_config, cfg)
        self.static = stack_static([static], self.device)
        self.N = len(flows)
        self.state = init_sim_state(params, cfg, self.static, self.N,
                                    self.num_links)
        self._step = make_event_step(cfg, self.static, self.num_links)
        self.fcts = np.full(self.N, np.nan, np.float64)
        # host mirror of state["t_arr"]: arrival times enter the arena only
        # from host floats (inject_arrival), so FCTs need no device pull
        self.t_arr_host = static["t_arrival"][:self.N].astype(np.float64)

    @torch.inference_mode()
    def next_departure(self):
        N, s = self.N, self.state
        live = s["arrived"][0, :N] & ~s["done"][0, :N]
        dep_t = torch.where(live, s["t_dep"][0, :N], BIG)
        i = dep_t.argmin()                     # first index on ties
        t, i = torch.stack([dep_t[i].double(), i.double()]).tolist()
        return (None, None) if t >= BIG / 2 else (t, int(i))

    def _event(self, t: float, fid: int, is_arrival: bool):
        dev = self.device
        self._step(self.params, self.state,
                   torch.full((1,), t, dtype=torch.float32, device=dev),
                   torch.full((1,), fid, dtype=torch.long, device=dev),
                   torch.full((1,), is_arrival, dtype=torch.bool,
                              device=dev))

    @torch.inference_mode()
    def inject_arrival(self, fid: int, t: float):
        # float32 cast keeps the mirror bitwise-equal to the device value
        self.t_arr_host[fid] = np.float32(t)
        self.state["t_arr"][0, fid] = t
        self._event(t, fid, True)
        self.state["arrived"][0, fid] = True

    @torch.inference_mode()
    def commit_departure(self, fid: int, t: float):
        self._event(t, fid, False)
        self.state["done"][0, fid] = True
        self.state["t_dep"][0, fid] = BIG
        self.fcts[fid] = t - self.t_arr_host[fid]

    def completion_times(self) -> np.ndarray:
        """Absolute completion time per flow (NaN while unfinished)."""
        return np.where(np.isfinite(self.fcts),
                        self.t_arr_host + self.fcts, np.nan)
