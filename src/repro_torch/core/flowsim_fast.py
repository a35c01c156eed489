"""flowSim on the card: the max-min event loop of `repro.core.flowsim_fast`
as a Python loop of 2N flow-level events over arenas of per-flow link
lists.

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
to one shape. The incidence travels as rows, (B, N, K) int32: each flow's
links from its path, ascending, -1 padded (`_pack`). From them the run
builds, once and on its device, what the water-filling reads
(`dispatch.waterfill_incidence`): on a card the kernel's lists
(`kernels/waterfill/layout.py`), on the CPU the dense incidence of the
plain version. No dense (B, N, L) array is made on the card's path.
The loop runs as one program of `repro_torch.core.compiled` per arena
shape: on a card the event step captured as a CUDA graph and replayed
2N times, on the CPU the same step run eagerly. Each new program
counts one in `TRACE_COUNTS` under the JAX package's names
("event_scan" for `run_flowsim_fast`, "event_scan_batched" for
`run_flowsim_fast_batch`). Where JAX takes its pmap path (more than one
device in `sharding.local_devices`, at least one scenario per device, no
probes), the batch is sharded across the devices, one program per device
and shard shape, and one new sharded call counts one
"event_scan_sharded". The program's rows (and on a card its incidence
lists) have room for `_list_width` links a flow (4, the longest path of
the repo's fat trees, or the next power of two above a longer one), so a
new width, and with it a new program, comes only with a path longer than
any the shape has seen; JAX's dense incidence has no such axis.
Everything is float32, as the reference runs with x64 off.
The two link sums of a round (unfrozen flows per link, rate in use per
link) are taken exactly, in float64, and rounded once to float32: the
reference leaves their summation order to XLA, and an exact sum makes
the card and the CPU agree bitwise, so a tie in the freeze test or the
departure race cannot break one way on the card and the other on the CPU.

`probes=` records, every `stride` events, the post-event state into
ring buffers on the device (`repro_torch.core.probes`): the max-min
rates of the active set (one more `waterfill_event` call, on stride hits
only), the exact remaining bytes, and the active flows per link (a
scatter-add over the rows). With probes off the loop is unchanged.
`record=True`, the per-event log the tests read, runs the same program
eagerly and uncached.

A call's host work is in spans (`repro_torch.obs.trace`): `sim.prep`
(the sizes and `_pack` of each scenario), `sim.upload` (`_to_device`'s
stacking and pageable copy of the rows, capacities and schedule; `bytes`,
`pinned`), `sim.incidence` (`width`: the lists' on a card, None for the
CPU's dense incidence), then the program's `compiled.run`, `sim.readback`
and `sim.results`; the caller's span gets N and L.
"""
from __future__ import annotations

import time
from collections import Counter

import numpy as np
import torch

from ..kernels import dispatch
from ..kernels.waterfill.layout import IncidenceLists
from ..kernels.waterfill.ref import BIG, MAX_ROUNDS, TIE  # noqa: F401
from ..obs.trace import NULL_SPAN, get_tracer
from . import compiled
from . import probes as _probes
from . import sharding
from .flowsim import FlowSimResult
from .probes import FLOWSIM_CHANNELS, ProbeConfig, normalize_probes


# New compiled programs per entry point ("event_scan",
# "event_scan_batched", "event_scan_sharded"), as the JAX package counts
# its XLA traces.
TRACE_COUNTS = Counter()


def _list_width(K: int) -> int:
    """Room for links per flow in a program's incidence lists: 4, the
    longest path of the repo's two-tier fat trees, or the next power of
    two at or above K."""
    return max(4, 1 << max(K - 1, 0).bit_length())


def _pad_rows(x, width: int):
    """(B, N, K) rows -> (B, N, width), -1 padded (which the kernel and the
    scatter-adds skip)."""
    return torch.nn.functional.pad(x, (0, width - x.shape[2]), value=-1)


def _pad_lists(lists: IncidenceLists, width: int) -> IncidenceLists:
    """The lists with room for `width` links a flow and for N · width
    entries, so that every call of one program launches with the same
    shapes and sizes."""
    N = lists.flow_links.shape[1]
    return IncidenceLists(_pad_rows(lists.flow_links, width), lists.link_ptr,
                          _pad_rows(lists.flow_entries, width), N * width)


def _link_active(links, active, num_links):
    """Active flows per link, (B, L) float32: `active` (B, N) bool added
    over each flow's `links` (B, N, K), -1 entries dropped. The counts are
    integers below 2**24, exact in float32 in any order of addition."""
    B = links.shape[0]
    on = (links >= 0) & active[..., None]
    idx = torch.where(on, links, num_links).long().view(B, -1)
    out = torch.zeros(B, num_links + 1, dtype=torch.float32,
                      device=links.device)
    return out.scatter_add_(1, idx, on.float().view(B, -1))[:, :num_links]


def _fs_program(links, cap, sizes_bits, arr_times, arr_order, incidence,
                length, probes) -> compiled.Program:
    """The event loop's program for arenas shaped like these: its own
    copies of the rows, the incidence built from them, capacities, sizes
    and schedule, the carried state, and one event step over them (with
    `probes`, also the rings, their hit counter and the read-out)."""
    B, N, _ = links.shape
    L = cap.shape[1]
    dev = links.device
    links, cap, sizes, times, order = (x.clone() for x in (
        links, cap, sizes_bits, arr_times, arr_order))
    if isinstance(incidence, IncidenceLists):
        inc = IncidenceLists(*(x.clone() for x in incidence[:3]),
                             incidence.nnz)
        inc_bufs = list(inc[:3])
    else:
        inc = incidence.clone()
        inc_bufs = [inc]
    b1 = torch.arange(B, dtype=torch.long, device=dev)
    remaining = torch.zeros(B, N, dtype=torch.float32, device=dev)
    active = torch.zeros(B, N, dtype=torch.bool, device=dev)
    fct = torch.zeros(B, N, dtype=torch.float32, device=dev)
    ptr = torch.zeros(B, dtype=torch.long, device=dev)
    t = torch.zeros(B, dtype=torch.float32, device=dev)
    carried = [remaining, active, fct, ptr, t]
    owned = [links, cap, sizes, times, order, *inc_bufs, *carried]
    bufs = hits = sample = None
    if probes is not None:
        bufs = _probes.init_buffers(probes, batch=B, num_flows=N,
                                    num_links=L, device=dev)
        hits = torch.zeros((), dtype=torch.long, device=dev)
        owned += [*bufs.values(), hits]
        vals = {
            # max-min rates of the post-event active set: one more
            # water-filling, on stride hits only
            "flow_rate": lambda: dispatch.waterfill_event(
                inc, cap, active, max_rounds=MAX_ROUNDS)[0],
            "flow_remaining": lambda: remaining / 8.0,     # bits -> bytes
            "link_active": lambda: _link_active(links, active, L),
        }

        def sample(t_ev):
            _probes.record(probes, bufs, hits, t_ev, vals)

    def load(links_, cap_, sizes_, times_, order_, incidence_):
        for dst, src in zip((links, cap, sizes, times, order),
                            (links_, cap_, sizes_, times_, order_)):
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


def _incidences(rows, num_links, width):
    """The water-filling's incidence of each of `rows` (one (B, N, K)
    block of rows per device), built once for a run on its device
    (`dispatch.waterfill_incidence`), the card's lists padded to `width`
    links a flow; and that width, or None for the CPU's dense
    incidence."""
    with torch.inference_mode():
        incs = [dispatch.waterfill_incidence(x, num_links) for x in rows]
    if not isinstance(incs[0], IncidenceLists):
        return incs, None
    return [_pad_lists(i, width) for i in incs], width


def _event_scan_sharded(links, cap, sizes_bits, arr_times, arr_order,
                        devices):
    """`_event_scan_sharded` of the JAX package: the (B, ...) arenas
    sharded (D, ceil(B/D), ...) by `sharding.shard_leaves`, shard i run on
    `devices[i]` through its program of 2N events, its incidence built on
    that device from its rows (the rows and lists of every shard padded to
    one width, so the shards share one key), counted once per new sharded
    key in TRACE_COUNTS["event_scan_sharded"]. Returns the absolute
    completion times (B, N) on the caller's device, pad replicas
    dropped."""
    B, N, _ = links.shape
    L = cap.shape[1]
    D = len(devices)
    width = _list_width(links.shape[2])
    cols = sharding.shard_leaves([_pad_rows(links, width), cap, sizes_bits,
                                  arr_times, arr_order], D)
    shards = [[x[i].to(dev) for x in cols] for i, dev in enumerate(devices)]
    with get_tracer().span("sim.incidence") as sp:
        incs, lists_width = _incidences([args[0] for args in shards], L,
                                        width)
        sp.attr("width", lists_width)
    key = (D, cols[0].shape[1], N, L, width)

    def build(*args):
        return _fs_program(*args, 2 * N, None)
    outs = compiled.run_sharded(
        TRACE_COUNTS, "event_scan_sharded", key, build,
        [(dev, (*args, inc)) for dev, args, inc in
         zip(devices, shards, incs)])
    return sharding.unshard(
        torch.stack([out[0].to(links.device) for out in outs]), B)


def _event_scan_core(links, cap, sizes_bits, arr_times, arr_order,
                     num_events=None, record=False,
                     probes: ProbeConfig = None,
                     entry: str = "event_scan_batched"):
    """2N events (or `num_events`) over arenas of N flows on L links (rows
    `links` (B, N, K), capacities (B, L)), through entry point `entry`'s
    compiled program for this key. Returns the absolute completion times
    (B, N); with `record` (eager, uncached and uncounted), also a dict of
    per-event (B, events) records: "fid", "is_arrival", and the
    water-filling's "rounds" and "capped" (see
    `repro_torch.kernels.waterfill.ref.waterfill_event_ref`); with
    `probes`, last the ring buffers (see `core.probes`)."""
    B, N, _ = links.shape
    L = cap.shape[1]
    length = 2 * N if num_events is None else num_events
    width = _list_width(links.shape[2])
    links = _pad_rows(links, width)
    with get_tracer().span("sim.incidence") as sp:
        (incidence,), lists_width = _incidences([links], L, width)
        sp.attr("width", lists_width)
    args = (links, cap, sizes_bits, arr_times, arr_order, incidence)

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
            log = {k: torch.stack(v, 1) if v
                   else torch.zeros(B, 0, dtype=torch.float32)
                   for k, v in log.items()}
        return (out[0], log) + out[1:]
    key = (B, N, L, width, num_events, probes)
    out = compiled.run(TRACE_COUNTS, entry, key, links.device, build, *args)
    return out[0] if len(out) == 1 else out


def _pack(topo, flows, n_total=None, l_total=None):
    """Incidence rows + capacities + arrival schedule, optionally padded to
    a shared shape. The rows are (N, K) int32: flow f's links
    `sorted(set(f.path))`, -1 padded, K the longest path. Padded flows
    have empty rows, 8 bits and arrive at t=BIG (strictly after every real
    event); padded links carry no flow and have capacity 1."""
    n = len(flows)
    N = n if n_total is None else n_total
    L = topo.num_links if l_total is None else l_total
    paths = [sorted(set(f.path)) for f in flows]
    links = np.full((N, max(map(len, paths), default=0)), -1, np.int32)
    for f, path in zip(flows, paths):
        links[f.fid, :len(path)] = path
    sizes = np.full(N, 8.0, np.float64)
    sizes[:n] = [float(f.size) * 8.0 for f in flows]
    cap = np.ones(L, np.float64)
    cap[:topo.num_links] = topo.capacity
    t_arr = np.full(N, BIG, np.float32)
    t_arr[:n] = [f.t_arrival for f in flows]
    order = np.argsort(t_arr, kind="stable").astype(np.int32)
    return links, cap, sizes, t_arr[order], order


def _to_device(packed, device):
    """Stacked numpy arenas -> (B, ...) tensors: the rows padded to the
    longest (B, N, K) int32; float64 sizes and capacities round to
    float32, as the reference's do with x64 off."""
    links, cap, sizes, times, order = zip(*packed)
    K = max(x.shape[1] for x in links)
    links = np.stack([np.pad(x, ((0, 0), (0, K - x.shape[1])),
                             constant_values=-1) for x in links])
    cap, sizes, times, order = (np.stack(x) for x in (cap, sizes, times,
                                                      order))
    f32 = lambda x: torch.from_numpy(x).to(device, torch.float32)  # noqa: E731
    return (torch.from_numpy(links).to(device), f32(cap), f32(sizes),
            f32(times), torch.from_numpy(order).to(device, torch.long))


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
                           probes: ProbeConfig = None, span=NULL_SPAN):
    """B (topo, flows) scenarios padded to the largest flow/link count and
    run as one batch of arenas. Returns a list of FlowSimResult; with
    `probes`, each carries its own series, trimmed to its flows and
    links. `span`, the caller's open span, gets the padded sizes N and L
    as attributes."""
    return _run(scenarios, device, probes, "event_scan_batched", span)


def _run(scenarios, device, probes, entry, span=NULL_SPAN):
    probes = normalize_probes(probes, FLOWSIM_CHANNELS)
    scenarios = list(scenarios)
    if not scenarios:
        return []
    tracer = get_tracer()
    dispatch.count_dispatch(device)
    with tracer.span("sim.prep"):
        n_max = max(len(flows) for _, flows in scenarios)
        l_max = max(topo.num_links for topo, _ in scenarios)
        packed = [_pack(topo, flows, n_total=n_max, l_total=l_max)
                  for topo, flows in scenarios]
    span.attr("N", n_max).attr("L", l_max)
    with tracer.span("sim.upload") as sp:
        args = _to_device(packed, device)
        del packed
        sp.attr("bytes", sum(x.numel() * x.element_size() for x in args))
        sp.attr("pinned", False)
    # JAX's pmap path: more than one device, a batch of at least one
    # scenario per device, and no probes
    devices = sharding.local_devices(device)
    t0 = time.perf_counter()
    if (entry == "event_scan_batched" and 1 < len(devices) <= len(scenarios)
            and probes is None):
        out = _event_scan_sharded(*args, devices)
    else:
        out = _event_scan_core(*args, probes=probes, entry=entry)
    with tracer.span("sim.readback"):
        if probes is None:
            fct_abs, bufs = out.cpu().numpy(), None
        else:
            fct_abs = out[0].cpu().numpy()
            bufs = _probes.buffers_numpy(out[1])
    wall = time.perf_counter() - t0
    results = []
    with tracer.span("sim.results"):
        for b, (topo, flows) in enumerate(scenarios):
            series = None
            if bufs is not None:
                series = _finalize_fs_series(
                    probes, {k: v[b] for k, v in bufs.items()}, topo, flows,
                    num_flows=n_max, num_links=l_max)
            results.append(_result(topo, flows, fct_abs[b],
                                   wall / len(scenarios), series))
    return results
