"""Plain PyTorch reference of m4's open loop (the paper's §3, Figures 2
and 5), for the benchmark's comparison.

A frozen, self-contained copy of the model's equations and of the event
loop's semantics, written for clarity, not speed: no kernel of the port,
no occupancy arenas. Each scenario of a batch runs in lock step:

- the event race: the next arrival against the earliest predicted
  departure (arrivals win ties, the lowest flow id wins a tie of
  departures);
- the snapshot, found densely: the event flow, then the lowest-numbered
  active flows that share a link with it, up to `snap_flows`; their
  links, ascending, up to `snap_links` (an edge to a link past the last
  one kept counts on the last slot, as the model defines it);
- GRU-1 / GRU-A over the time since each state's last update, three
  GraphSAGE rounds (sum aggregation over the snapshot's flow-link
  edges), GRU-2 / GRU-B, and MLP-sldn's new departure times, written
  back for the snapshot's live flows and links.

It builds every table (paths, features, ideal completion times) from the
scenario's plain data itself and shares nothing with the program but the
weights and the scenarios the benchmark made. Matrix products run in
float32 with TF32 off unless `tf32=True` (the control's precision).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

BIG = 1e30
MTU_BYTES = 1000.0


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def ideal_fct(size, path, net) -> float:
    """Unloaded completion time: serialisation at the bottleneck,
    propagation, and one MTU stored and forwarded per hop after the
    first (every link of the fat tree has one capacity)."""
    cap = net.capacity_bps
    prop = sum(net.prop_delay_s for _ in path)
    hops = sum(MTU_BYTES * 8.0 / cap for _ in path[1:])
    return size * 8.0 / cap + prop + hops


def cfg_vector(point) -> np.ndarray:
    """The 9-d network-configuration input (§3.4): the congestion
    control one-hot and its knobs, each over its range's top."""
    one_hot = {"dctcp": [1, 0, 0], "dcqcn": [0, 1, 0],
               "timely": [0, 0, 1]}[point["cc"]]
    return np.array(one_hot + [
        point["init_window"] / 15e3, point["buffer_bytes"] / 160e3,
        point["dctcp_k"] / 30e3, point["dcqcn_kmin"] / 30e3,
        point["dcqcn_kmax"] / 50e3, point["timely_thigh"] / 150e-6],
        dtype=np.float32)


def tables(scenarios, P: int):
    """Per-scenario inputs, stacked and padded to the batch's largest flow
    and link counts: paths (-1 padded), flow and link features, ideal
    completion times, arrivals, config vectors."""
    B = len(scenarios)
    N = max(s.num_flows for s in scenarios)
    L = max(s.net.num_links for s in scenarios)
    paths = np.full((B, N, P), -1, np.int64)
    feat = np.zeros((B, N, 3), np.float32)
    ideal = np.full((B, N), 1e-9, np.float32)
    t_arr = np.full((B, N), BIG, np.float32)
    link_feat = np.zeros((B, L, 1), np.float32)
    cfg = np.stack([cfg_vector(s.point) for s in scenarios])
    for b, s in enumerate(scenarios):
        n = s.num_flows
        for f, p in enumerate(s.paths):
            paths[b, f, :len(p)] = p[:P]
        sizes = s.size.astype(np.float32)
        hops = (paths[b, :n] >= 0).sum(1).astype(np.float32)
        ideal[b, :n] = [ideal_fct(float(z), p, s.net)
                        for z, p in zip(s.size, s.paths)]
        feat[b, :n] = np.stack([np.log1p(sizes / np.float32(1e3)) / 10.0,
                                hops / 8.0,
                                np.log1p(ideal[b, :n] / np.float32(1e-6))
                                / 10.0], -1)
        t_arr[b, :n] = s.t_arrival
        link_feat[b, :, 0] = np.log1p(s.net.capacity_bps / 1e9) / 10.0
    return paths, feat, ideal, t_arr, link_feat, cfg


def linear(p, x):
    return x @ p["w"] + p["b"]


def mlp(p, x):
    for i in range(len(p)):
        x = linear(p[f"l{i}"], x)
        if i < len(p) - 1:
            x = torch.relu(x)
    return x


def gru(p, x, h):
    gi = x @ p["wi"] + p["bi"]
    gh = h @ p["wh"] + p["bh"]
    ir, iz, i_n = gi.chunk(3, -1)
    hr, hz, hn = gh.chunk(3, -1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(i_n + r * hn)
    return (1.0 - z) * n + z * h


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def with_cfg(x, cfg):
    return torch.cat([x, cfg[:, None, :].expand(*x.shape[:2], -1)], -1)


def time_feat(dt):
    return torch.log1p(torch.clamp(dt, min=0.0) / 1e-6) / 10.0


def first_distinct(vals, k: int, fill: int):
    """The first k distinct values of each row of `vals` (B, M),
    ascending, padded with `fill` (which bounds every real value)."""
    s = vals.sort(1).values
    new = torch.ones_like(s, dtype=torch.bool)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    new &= s < fill
    rank = new.cumsum(1) - 1
    out = torch.full((s.shape[0], k + 1), fill, dtype=s.dtype,
                     device=s.device)
    out.scatter_(1, torch.where(new & (rank < k), rank, k), s)
    return out[:, :k]


@torch.no_grad()
def run(scenarios, params, model: dict, device, *, tf32=False, graph=True):
    """Completion times (B, N) float32 of a batch of scenarios (rows past
    a scenario's flow count are padding), and the live GNN edges summed
    over every event, per scenario (B,) (for the operation count).
    `graph=False` launches every event's operations from Python on a card
    too."""
    SF, SL, P = model["snap_flows"], model["snap_links"], model["max_path"]
    paths, feat, ideal, t_arr, link_feat, cfg = tables(scenarios, P)
    B, N = t_arr.shape
    L = link_feat.shape[1]
    H = model["hidden"]
    dev = torch.device(device)
    T = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    paths, feat, ideal, t_arr, link_feat, cfg = map(
        T, (paths, feat, ideal, t_arr, link_feat, cfg))
    bi = torch.arange(B, device=dev)
    b2 = bi[:, None]
    ids = torch.arange(N, device=dev).expand(B, N)
    edge_f = torch.arange(SF, device=dev).repeat_interleave(P)
    # arrival order (stable) and its times
    order = torch.from_numpy(np.argsort(t_arr.cpu().numpy(), 1,
                                        kind="stable")).to(dev)
    arr_times = t_arr.gather(1, order)
    # per-flow state; row N (flows) and row L (links) absorb the writes of
    # masked snapshot slots and are never read for a live one
    t_arr1 = torch.cat([t_arr, torch.zeros(B, 1, device=dev)], 1)
    with matmul_precision(tf32):
        link_h = torch.zeros(B, L + 1, H, device=dev)
        link_h[:, :L] = torch.tanh(mlp(params["link_init"],
                                       with_cfg(link_feat, cfg)))
        flow_h = torch.zeros(B, N + 1, H, device=dev)
        flow_last = torch.zeros(B, N + 1, device=dev)
        link_last = torch.zeros(B, L + 1, device=dev)
        t_dep = torch.full((B, N + 1), BIG, device=dev)
        fct = torch.zeros(B, N, device=dev)
        active = torch.zeros(B, N, dtype=torch.bool, device=dev)
        ptr = torch.zeros(B, dtype=torch.long, device=dev)
        live_edges = torch.zeros(B, device=dev)

        def event():
            """One event of every scenario, in place."""
            # the race
            pc = ptr.clamp(max=N - 1)
            next_arr = torch.where(ptr < N, arr_times[bi, pc],
                                   torch.full_like(arr_times[:, 0], BIG))
            dep_t = torch.where(active, t_dep[:, :N], BIG)
            dep_i = dep_t.argmin(1)
            next_dep = dep_t[bi, dep_i]
            is_arr = next_arr <= next_dep
            t_ev = torch.where(is_arr, next_arr, next_dep)
            fid = torch.where(is_arr, order[bi, pc], dep_i)
            # the snapshot's flows
            ev_links = paths[bi, fid]                               # (B, P)
            share = ((paths[:, :, :, None] == ev_links[:, None, None, :])
                     & (ev_links[:, None, None, :] >= 0)).any(3).any(2)
            cand = share & active & (ids != fid[:, None])
            others = torch.where(cand, ids, N).sort(1).values[:, :SF - 1]
            if others.shape[1] < SF - 1:        # fewer flows than slots
                others = torch.cat([others, others.new_full(
                    (B, SF - 1 - others.shape[1]), N)], 1)
            snap_f = torch.cat([fid[:, None], others], 1)           # (B, SF)
            f_live = snap_f < N
            fg = snap_f.clamp(max=N - 1)
            # ... and links, with the edges between them
            gl = paths[b2, fg]                                  # (B, SF, P)
            gl = torch.where((gl >= 0) & f_live[..., None], gl,
                             L).reshape(B, SF * P)
            snap_l = first_distinct(gl, SL, L)                      # (B, SL)
            l_live = snap_l < L
            edge_live = gl < L
            edge_l = torch.where(edge_live, torch.searchsorted(
                snap_l.contiguous(), gl).clamp(max=SL - 1), 0)
            live_edges.add_(edge_live.sum(1))
            inc = torch.zeros(B, SF * SL, device=dev)
            inc.scatter_add_(1, edge_f * SL + edge_l, edge_live.float())
            inc = inc.view(B, SF, SL)
            # gather the states
            lg = torch.where(l_live, snap_l, L)
            f_h = flow_h[b2, snap_f]
            l_h = link_h[b2, lg]
            fresh = torch.tanh(mlp(params["flow_init"], torch.cat(
                [feat[bi, fid], cfg], -1)))
            f_h[:, 0] = torch.where(is_arr[:, None], fresh, f_h[:, 0])
            dt_f = t_ev[:, None] - flow_last[b2, snap_f]
            dt_f[:, 0] = torch.where(is_arr, 0.0, dt_f[:, 0])
            dt_l = t_ev[:, None] - link_last[b2, lg]
            f_x = with_cfg(torch.cat([time_feat(dt_f)[..., None],
                                      feat[b2, fg]], -1), cfg)
            l_x = with_cfg(torch.cat([time_feat(dt_l)[..., None],
                                      link_feat[b2, lg.clamp(max=L - 1)]],
                                     -1), cfg)
            # temporal, spatial, state refresh, departures
            f_h = gru(params["gru1"], f_x, f_h)
            l_h = gru(params["gruA"], l_x, l_h)
            f = torch.relu(linear(params["proj_f"], f_h))
            l = torch.relu(linear(params["proj_l"], l_h))
            for layer in params["gnn"]:
                agg_f = inc @ l
                agg_l = inc.transpose(1, 2) @ f
                f, l = (torch.relu(linear(layer["wf"],
                                          torch.cat([f, agg_f], -1))),
                        torch.relu(linear(layer["wl"],
                                          torch.cat([l, agg_l], -1))))
            f_h = gru(params["gru2"], with_cfg(f, cfg), f_h)
            l_h = gru(params["gruB"], with_cfg(l, cfg), l_h)
            hops = feat[b2, fg, 1] * 8.0
            sldn = 1.0 + softplus(mlp(params["mlp_sldn"], with_cfg(
                torch.cat([f_h, (hops / 8.0)[..., None]], -1), cfg))[..., 0])
            dep = torch.maximum(t_arr1[b2, snap_f] + sldn * ideal[b2, fg],
                                (t_ev + 1e-9)[:, None])
            # write back the live slots
            fw = torch.where(f_live, snap_f, N)
            flow_h[b2, fw] = f_h
            flow_last[b2, fw] = t_ev[:, None].expand(B, SF)
            t_dep[b2, fw] = dep
            link_h[b2, lg] = l_h
            link_last[b2, lg] = t_ev[:, None].expand(B, SL)
            # the event itself
            gone = ~is_arr
            fct[bi, fid] = torch.where(gone, t_ev - t_arr[bi, fid],
                                       fct[bi, fid])
            t_dep[bi, fid] = torch.where(gone, BIG, t_dep[bi, fid])
            active[bi, fid] = is_arr
            ptr.add_(is_arr.long())

        # on a card the event is captured once and replayed: the same
        # kernels as eagerly, without a launch from Python for each
        events = 2 * N
        if graph and dev.type == "cuda" and events > 1:
            event()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                event()
            for _ in range(events - 1):
                graph.replay()
        else:
            for _ in range(events):
                event()
    return fct.cpu().numpy(), live_edges.cpu().numpy()
