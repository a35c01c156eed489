"""flowSim on the card: the max-min event loop of `repro.core.flowsim_fast`
as a Python loop of 2N flow-level events over dense incidence arenas.

Each event recomputes the max-min rates of the active flows by
progressive water-filling, up to `MAX_ROUNDS` = 32 rounds, in one call
of `repro_torch.kernels.dispatch.waterfill_event`: for a CUDA tensor one
launch of the hand-written kernel, which holds the event in shared
memory and stops once every flow is frozen; for a CPU tensor the plain
version (`kernels/waterfill/ref.py`), exactly 32 dense rounds (once every
flow is frozen a round changes nothing, so the fixed count equals the
reference's `while_loop` and needs no host sync). Where 32 rounds do not
freeze every flow, the flows left get rate 0 for that event, as in the
reference. Then the next arrival races the earliest departure and the
remaining sizes drain linearly.

Arenas carry a leading batch axis B, one scenario per row
(`run_flowsim_fast` is B = 1); `run_flowsim_fast_batch` pads B scenarios
to one shape. The loop runs as one program of `repro_torch.core.compiled`
per arena shape: on a card the event step captured as a CUDA graph and
replayed 2N times, on the CPU the same step run eagerly. Each new program
counts one in `TRACE_COUNTS` under the JAX package's names
("event_scan" for `run_flowsim_fast`, "event_scan_batched" for
`run_flowsim_fast_batch`). On a card the program's incidence lists have
room for `_list_width` links a flow (4, the longest path of the repo's
fat trees, or the next power of two above a longer one), so a new width,
and with it a new capture, comes only with a path longer than any the
shape has seen; JAX's dense incidence has no such axis. Everything is
float32, as the reference runs with x64 off.
The two link sums of a round (unfrozen flows per link, rate in use per
link) are taken exactly, in float64, and rounded once to float32: the
reference leaves their summation order to XLA, and an exact sum makes
the card and the CPU agree bitwise, so a tie in the freeze test or the
departure race cannot break one way on the card and the other on the CPU.

`probes=` records, every `stride` events, the post-event state into
ring buffers on the device (`repro_torch.core.probes`): the max-min
rates of the active set (one more `waterfill_event` call, on stride hits
only), the exact remaining bytes, and the active flows per link. With
probes off the loop is unchanged. `record=True`, the per-event log the
tests read, runs the same program eagerly and uncached.
"""
from __future__ import annotations

import time
from collections import Counter

import numpy as np
import torch

from ..kernels import dispatch
from ..kernels.waterfill.layout import IncidenceLists
from ..kernels.waterfill.ref import BIG, MAX_ROUNDS, TIE  # noqa: F401
from . import compiled
from . import probes as _probes
from .flowsim import FlowSimResult
from .probes import FLOWSIM_CHANNELS, ProbeConfig, normalize_probes


# New compiled programs per entry point ("event_scan",
# "event_scan_batched"), as the JAX package counts its XLA traces.
TRACE_COUNTS = Counter()


def _list_width(K: int) -> int:
    """Room for links per flow in a program's incidence lists: 4, the
    longest path of the repo's two-tier fat trees, or the next power of
    two at or above K."""
    return max(4, 1 << max(K - 1, 0).bit_length())


def _pad_lists(lists: IncidenceLists, width: int) -> IncidenceLists:
    """The lists with room for `width` links a flow (-1 padded, which the
    kernel skips) and for N · width entries, so that every call of one
    program launches with the same shapes and sizes."""
    B, N, K = lists.flow_links.shape
    pad = (0, width - K)
    return IncidenceLists(
        torch.nn.functional.pad(lists.flow_links, pad, value=-1),
        lists.link_ptr,
        torch.nn.functional.pad(lists.flow_entries, pad, value=-1),
        N * width)


def _fs_program(a, cap, sizes_bits, arr_times, arr_order, incidence,
                length, probes) -> compiled.Program:
    """The event loop's program for arenas shaped like these: its own
    copies of the incidence (both forms), capacities, sizes and schedule,
    the carried state, and one event step over them (with `probes`, also
    the rings, their hit counter and the read-out)."""
    B, N, _ = a.shape
    dev = a.device
    a, cap, sizes, times, order = (x.clone() for x in (
        a, cap, sizes_bits, arr_times, arr_order))
    if isinstance(incidence, IncidenceLists):
        inc = IncidenceLists(*(x.clone() for x in incidence[:3]),
                             incidence.nnz)
        inc_bufs = list(inc[:3])
    else:
        inc = incidence.clone()
        inc_bufs = [inc]
    b1 = torch.arange(B, device=dev)
    remaining = torch.zeros(B, N, device=dev)
    active = torch.zeros(B, N, dtype=torch.bool, device=dev)
    fct = torch.zeros(B, N, device=dev)
    ptr = torch.zeros(B, dtype=torch.long, device=dev)
    t = torch.zeros(B, device=dev)
    carried = [remaining, active, fct, ptr, t]
    owned = [a, cap, sizes, times, order, *inc_bufs, *carried]
    bufs = hits = sample = None
    if probes is not None:
        bufs = _probes.init_buffers(probes, batch=B, num_flows=N,
                                    num_links=a.shape[2], device=dev)
        hits = torch.zeros((), dtype=torch.long, device=dev)
        owned += [*bufs.values(), hits]
        vals = {
            # max-min rates of the post-event active set: one more
            # water-filling, on stride hits only
            "flow_rate": lambda: dispatch.waterfill_event(
                inc, cap, active, max_rounds=MAX_ROUNDS)[0],
            "flow_remaining": lambda: remaining / 8.0,     # bits -> bytes
            "link_active": lambda: torch.bmm(
                active.float()[:, None], a)[:, 0],
        }

        def sample(t_ev):
            _probes.record(probes, bufs, hits, t_ev, vals)

    def load(a_, cap_, sizes_, times_, order_, incidence_):
        for dst, src in zip((a, cap, sizes, times, order),
                            (a_, cap_, sizes_, times_, order_)):
            dst.copy_(src)
        src = incidence_[:3] if isinstance(incidence_, IncidenceLists) \
            else [incidence_]
        for dst, x in zip(inc_bufs, src):
            dst.copy_(x)
        for x in carried:
            x.zero_()
        if bufs is not None:
            _probes.reset_buffers(bufs)
            hits.zero_()

    def logged_event():
        """One event for every scenario, in place; returns (t_ev, fid,
        is_arrival, rounds, capped)."""
        rates, rounds, capped = dispatch.waterfill_event(
            inc, cap, active, max_rounds=MAX_ROUNDS)
        tta = torch.where(active & (rates > 0),
                          remaining / rates.clamp_min(1e-9), BIG)
        dep_i = tta.argmin(1)                  # first index on ties
        next_dep = t + tta.gather(1, dep_i[:, None])[:, 0]
        pc = ptr.clamp(max=N - 1)[:, None]
        next_arr = torch.where(ptr < N, times.gather(1, pc)[:, 0], BIG)
        is_arr = next_arr <= next_dep          # arrivals win ties
        t_ev = torch.where(is_arr, next_arr, next_dep)
        dt = torch.clamp_min(t_ev - t, 0.0)
        remaining.copy_(torch.where(active, remaining - rates * dt[:, None],
                                    remaining))
        fid = torch.where(is_arr, order.gather(1, pc)[:, 0], dep_i)
        # arrival: activate; departure: deactivate and record the time
        active[b1, fid] = is_arr
        fct[b1, fid] = torch.where(is_arr, fct[b1, fid], t_ev)
        remaining[b1, fid] = torch.where(is_arr, sizes[b1, fid], 0.0)
        ptr.add_(is_arr.long())
        t.copy_(t_ev)
        return t_ev, fid, is_arr, rounds, capped

    def result():
        out = (fct.clone(),)
        if bufs is not None:
            out += ({k: v.clone() for k, v in bufs.items()},)
        return out

    prog = compiled.Program(
        load=load, event=lambda: logged_event()[0], sample=sample,
        stride=None if probes is None else probes.stride, length=length,
        result=result, buffers=owned)
    prog.logged_event = logged_event
    return prog


def _event_scan_core(a, cap, sizes_bits, arr_times, arr_order,
                     num_events=None, record=False,
                     probes: ProbeConfig = None,
                     entry: str = "event_scan_batched"):
    """2N events (or `num_events`) over (B, N, L) arenas, through entry
    point `entry`'s compiled program for this key. Returns the absolute
    completion times (B, N); with `record` (eager, uncached and
    uncounted), also a dict of per-event (B, events) records: "fid",
    "is_arrival", and the water-filling's "rounds" and "capped" (see
    `repro_torch.kernels.waterfill.ref.waterfill_event_ref`); with
    `probes`, last the ring buffers (see `core.probes`)."""
    B, N, L = a.shape
    length = 2 * N if num_events is None else num_events
    with torch.inference_mode():
        incidence = dispatch.waterfill_incidence(a)    # fixed for the run
        width = None
        if isinstance(incidence, IncidenceLists):
            width = _list_width(incidence.flow_links.shape[2])
            incidence = _pad_lists(incidence, width)
    args = (a, cap, sizes_bits, arr_times, arr_order, incidence)

    def build(*args):
        return _fs_program(*args, length, probes)
    if record:
        with torch.inference_mode():
            prog = build(*args)
            prog.load(*args)
            log = {k: [] for k in ("fid", "is_arrival", "rounds", "capped")}
            for ev in range(length):
                t_ev, *rec = prog.logged_event()
                if probes is not None and ev % probes.stride == 0:
                    prog.sample(t_ev)
                for k, v in zip(log, rec):
                    log[k].append(v)
            out = prog.result()
            log = {k: torch.stack(v, 1) if v else torch.zeros(B, 0)
                   for k, v in log.items()}
        return (out[0], log) + out[1:]
    key = (B, N, L, width, num_events, probes)
    out = compiled.run(TRACE_COUNTS, entry, key, a.device, build, *args)
    return out[0] if len(out) == 1 else out


def _pack(topo, flows, n_total=None, l_total=None):
    """Dense incidence + arrival schedule, optionally padded to a shared
    shape. Padded flows have empty paths, 8 bits and arrive at t=BIG
    (strictly after every real event); padded links carry no flow and
    have capacity 1."""
    n = len(flows)
    N = n if n_total is None else n_total
    L = topo.num_links if l_total is None else l_total
    a = np.zeros((N, L), np.float32)
    for f in flows:
        a[f.fid, f.path] = 1.0
    sizes = np.full(N, 8.0, np.float64)
    sizes[:n] = [float(f.size) * 8.0 for f in flows]
    cap = np.ones(L, np.float64)
    cap[:topo.num_links] = topo.capacity
    t_arr = np.full(N, BIG, np.float32)
    t_arr[:n] = [f.t_arrival for f in flows]
    order = np.argsort(t_arr, kind="stable").astype(np.int32)
    return a, cap, sizes, t_arr[order], order


def _to_device(packed, device):
    """Stacked numpy arenas -> (B, ...) tensors: float64 sizes and
    capacities round to float32, as the reference's do with x64 off."""
    a, cap, sizes, times, order = (np.stack(col) for col in zip(*packed))
    f32 = lambda x: torch.from_numpy(x).to(device, torch.float32)  # noqa: E731
    return (f32(a), f32(cap), f32(sizes), f32(times),
            torch.from_numpy(order).to(device, torch.long))


def _result(topo, flows, fct_abs, wall, series=None):
    arr = np.array([f.t_arrival for f in flows])
    fcts = fct_abs[:len(flows)] - arr
    ideal = np.array([topo.ideal_fct(f.size, f.path) for f in flows])
    empty = np.zeros(0, np.float64)
    return FlowSimResult(fcts=fcts, slowdowns=fcts / ideal,
                         event_times=empty, event_types=empty,
                         event_fids=empty, wallclock=wall, probes=series)


def _finalize_fs_series(probes, bufs, topo, flows, *, num_flows, num_links):
    series = _probes.finalize(probes, bufs, num_flows=num_flows,
                              num_links=num_links, trim_flows=len(flows),
                              trim_links=topo.num_links)
    series["meta"] = {"backend": "flowsim_fast",
                      "units": {"flow_rate": "bits/s",
                                "flow_remaining": "bytes",
                                "link_active": "flows"}}
    return series


def run_flowsim_fast(topo, flows, device="cuda", probes: ProbeConfig = None):
    """Drop-in fast path for `run_flowsim` (fcts + slowdowns only).
    `probes` records exact remaining-size / water-filling-rate /
    link-occupancy series into `FlowSimResult.probes`; None runs the
    unprobed loop."""
    return _run([(topo, flows)], device, probes, "event_scan")[0]


def run_flowsim_fast_batch(scenarios, device="cuda",
                           probes: ProbeConfig = None):
    """B (topo, flows) scenarios padded to the largest flow/link count and
    run as one batch of arenas. Returns a list of FlowSimResult; with
    `probes`, each carries its own series, trimmed to its flows and
    links."""
    return _run(scenarios, device, probes, "event_scan_batched")


def _run(scenarios, device, probes, entry):
    probes = normalize_probes(probes, FLOWSIM_CHANNELS)
    scenarios = list(scenarios)
    if not scenarios:
        return []
    dispatch.count_dispatch(device)
    n_max = max(len(flows) for _, flows in scenarios)
    l_max = max(topo.num_links for topo, _ in scenarios)
    args = _to_device([_pack(topo, flows, n_total=n_max, l_total=l_max)
                       for topo, flows in scenarios], device)
    t0 = time.perf_counter()
    out = _event_scan_core(*args, probes=probes, entry=entry)
    if probes is None:
        fct_abs, bufs = out.cpu().numpy(), None
    else:
        fct_abs = out[0].cpu().numpy()
        bufs = _probes.buffers_numpy(out[1])
    wall = time.perf_counter() - t0
    results = []
    for b, (topo, flows) in enumerate(scenarios):
        series = None
        if bufs is not None:
            series = _finalize_fs_series(
                probes, {k: v[b] for k, v in bufs.items()}, topo, flows,
                num_flows=n_max, num_links=l_max)
        results.append(_result(topo, flows, fct_abs[b],
                               wall / len(scenarios), series))
    return results
