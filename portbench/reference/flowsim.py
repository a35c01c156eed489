"""Plain numpy reference of flowSim (max-min fair flow-level simulation,
the m4 paper's §2.1 baseline), for the benchmark's comparison.

Each scenario of a batch runs in lock step, event by event: the max-min
rates of the active flows by progressive water-filling, the next arrival
raced against the earliest departure at those rates (arrivals win ties,
the lowest flow id wins a tie of departures), the remaining bits drained
linearly to the event's time, then the event applied.

The water-filling, up to 32 rounds an event: per round, the unfrozen
flows on each link and the rate the frozen ones use there, the fair share
of what is left, each unfrozen flow's bottleneck share, and the flows at
the smallest share frozen at it. A flow still unfrozen after the last
round gets rate 0 for that event. Everything is float32 but the two link
sums, which are taken in float64 (exact for these magnitudes, so in any
order) and rounded once. The control (`control=True`) rounds every
float32 result to bfloat16's precision.

Only the active flows' (flow, link) pairs are visited, so a round costs
what the active set costs, whatever the network's size.
"""
from __future__ import annotations

import numpy as np

BIG = np.float32(1e30)
INF = np.float32(3.4e38)
MAX_ROUNDS = 32
F32 = np.float32


def tables(scenarios):
    """Stacked inputs, padded to the batch's largest flow and link counts
    (padded flows have no link and arrive at BIG; padded links carry
    none): per flow its links (-1 padded), bits, arrival; per link its
    capacity."""
    B = len(scenarios)
    N = max(s.num_flows for s in scenarios)
    L = max(s.net.num_links for s in scenarios)
    K = max(len(p) for s in scenarios for p in s.paths)
    links = np.full((B, N, K), -1, np.int64)
    bits = np.full((B, N), 8.0, np.float32)
    t_arr = np.full((B, N), BIG, np.float32)
    cap = np.ones((B, L), np.float32)
    for b, s in enumerate(scenarios):
        n = s.num_flows
        for f, p in enumerate(s.paths):
            links[b, f, :len(p)] = p
        bits[b, :n] = s.size.astype(np.float64) * 8.0
        t_arr[b, :n] = s.t_arrival
        cap[b, :s.net.num_links] = s.net.capacity_bps
    return links, bits, t_arr, cap


def bfloat16(x):
    """x rounded to bfloat16's precision (to nearest, ties to even), kept
    as float32: the control's arithmetic."""
    x = np.asarray(x, np.float32)
    u = x.view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def exact(x):
    return np.asarray(x, np.float32)


def waterfill(links, cap, active, r=exact):
    """Max-min rates of the active flows. links (B, N, K), cap (B, L),
    active (B, N); `r` rounds each float32 result (the identity but in
    the control). Returns rates (B, N) float32 and the rounds each
    scenario ran (B,)."""
    B, N, K = links.shape
    L = cap.shape[1]
    flows = np.flatnonzero(active.reshape(-1))          # active flows
    fl = links.reshape(B * N, K)[flows]                 # (A, K)
    scen = flows // N
    ent = fl >= 0
    ent_row = np.nonzero(ent)[0]                        # entry -> flow row
    # the links these flows cross, numbered 0..U-1; U stands for "none"
    uniq, local = np.unique((fl + (scen * L)[:, None])[ent],
                            return_inverse=True)
    U = len(uniq)
    fl_local = np.full(fl.shape, U, np.int64)
    fl_local[ent] = local
    cap_u = cap.reshape(-1)[uniq]
    rates = np.zeros(len(flows), np.float32)
    frozen = np.zeros(len(flows), bool)
    rounds = np.zeros(B, np.int64)
    share = np.empty(U + 1, np.float32)
    share[U] = INF
    for _ in range(MAX_ROUNDS):
        if frozen.all():
            break
        rounds += np.bincount(scen[~frozen], minlength=B) > 0
        # the two link sums, in float64 (exact here), rounded once
        n_l = np.bincount(local, weights=(~frozen[ent_row]).astype(
            np.float64), minlength=U).astype(np.float32)
        used = r(np.bincount(local, weights=np.where(
            frozen, rates, F32(0))[ent_row].astype(np.float64),
            minlength=U).astype(np.float32))
        avail = r(np.maximum(r(cap_u - used), F32(0)))
        share[:U] = np.where(n_l > 0, r(avail / np.maximum(n_l, F32(1))),
                             BIG)
        f_share = share[fl_local].min(1)
        theta = np.full(B, BIG, np.float32)
        np.minimum.at(theta, scen[~frozen], f_share[~frozen])
        newly = ~frozen & (f_share <= theta[scen])
        rates = np.where(newly, f_share, rates)
        frozen |= newly
    out = np.zeros(B * N, np.float32)
    out[flows] = np.where(frozen, rates, F32(0))
    return out.reshape(B, N), rounds


def run(scenarios, *, control=False):
    """Absolute completion times (B, N) float32 of a batch, and the
    water-filling rounds of every event per scenario (events, B).
    `control` runs every float32 result at bfloat16's precision."""
    r = bfloat16 if control else exact
    links, bits, t_arr, cap = (r(x) if x.dtype == np.float32 else x
                               for x in tables(scenarios))
    B, N = t_arr.shape
    bi = np.arange(B)
    order = np.argsort(t_arr, 1, kind="stable")
    arr_times = np.take_along_axis(t_arr, order, 1)
    remaining = np.zeros((B, N), np.float32)
    active = np.zeros((B, N), bool)
    fct = np.zeros((B, N), np.float32)
    ptr = np.zeros(B, np.int64)
    t = np.zeros(B, np.float32)
    rounds = np.zeros((2 * N, B), np.int64)
    for ev in range(2 * N):
        rates, rounds[ev] = waterfill(links, cap, active, r)
        tta = np.full((B, N), BIG, np.float32)
        go = active & (rates > 0)
        tta[go] = r(remaining[go] / np.maximum(rates[go], F32(1e-9)))
        dep_i = tta.argmin(1)
        next_dep = r(t + tta[bi, dep_i])
        pc = np.minimum(ptr, N - 1)
        next_arr = np.where(ptr < N, arr_times[bi, pc], BIG)
        is_arr = next_arr <= next_dep
        t_ev = np.where(is_arr, next_arr, next_dep)
        dt = r(np.maximum(r(t_ev - t), F32(0)))
        remaining = np.where(active, r(remaining - r(rates * dt[:, None])),
                             remaining)
        fid = np.where(is_arr, order[bi, pc], dep_i)
        active[bi, fid] = is_arr
        fct[bi, fid] = np.where(is_arr, fct[bi, fid], t_ev)
        remaining[bi, fid] = np.where(is_arr, bits[bi, fid], F32(0))
        ptr += is_arr
        t = t_ev.astype(np.float32)
    return fct, rounds
