#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (m4 and flowSim) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. card        — name and power limit (nvidia-smi);
2. build       — nvcc builds the kernels from src/repro_torch/kernels/csrc;
3. kernel      — each kernel against its plain PyTorch version on the card
                 at the main paths' shapes (both GRU stages; the GNN's
                 gnn_layers rounds of one event in one launch at B = 1 and
                 B = 4 on random edges, one round alone, and B = 1 on the
                 real snapshot with the largest link fan-in over the first
                 300 events of m4's 2000-flow `run`, each also bitwise
                 against a second launch; the water-filling row-min at
                 2000 flows and 80/96/128 links, B = 1 and 4, and a ragged
                 shape, bitwise): errors, device times (CUDA-graph replay,
                 so host overhead is excluded), bound, library call;
4. full        — m4 at the paper's full width (M4Config defaults, seeded
                 random weights): `run` of one 2000-flow Table-2 scenario,
                 then `run_many` of four, through get_backend("m4"); then
                 flowsim_fast the same way (2000 flows, `run` of the seed
                 where the 32-round water-filling cap binds). Every flow
                 done, FCTs finite and positive, and the launch counters
                 show each path's kernels (m4: 2 GRU-pair launches and 1
                 GNN launch per event; flowsim_fast: 32 row-min launches
                 per event);
5. profile     — a short run of each path under torch.profiler: device
                 busy share, CUDA kernels launched per event, and the
                 device time per event of each of the port's kernels;
6. cpu         — the card against the CPU: m4 with the same weights on a
                 200-flow scenario, flowsim_fast on the 2000-flow `run`
                 scenario, FCTs at rtol 1e-4 (for flowsim_fast also the
                 water-filling rounds per event, and, if the FCTs differ,
                 the first event whose (fid, is_arrival) differs);
7. closed_loop — the §5.4 closed loop (per-rack inflight 3) on a 2-client-
                 rack backlog of 500 flows through run_closed_loop, for m4
                 at full width and for flowsim_fast: every flow completes,
                 and m4's launch counters read 2 GRU-pair launches and 1
                 GNN launch per event.

Then the `kernels` line, the card's nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed check raises, so the script
exits nonzero and prints no result; so it does with no CUDA device, or
when run outside the repository. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet): fp32 on the CUDA cores and
# HBM3 bandwidth; the bound of a launch is the larger of the two times
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PORT_KERNELS = ("gru_pair_kernel", "bipartite_rounds_kernel",
                "masked_rowmin_kernel")
GRU_TOL = 1e-5
GNN_TOL = 1e-4
FCT_RTOL = 1e-4


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def device_ms(torch, fn, reps=50, replays=5):
    """Device time of one fn() call: `reps` calls captured in a CUDA graph,
    replayed `replays` times between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def max_err(torch, got, want):
    d = (got - want).abs()
    return float(d.max()), float((d / want.abs().clamp(min=1e-6)).max())


def check_close(torch, name, got, want, tol):
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        a, r = max_err(torch, got, want)
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs {a}, max rel {r}, tol {tol})")


def phase_kernels(torch, params, cfg, dev):
    from repro_torch.kernels.bipartite import ops as bip_ops
    from repro_torch.kernels.bipartite import ref as bip_ref
    from repro_torch.kernels.fused_gru import ops as gru_ops
    from repro_torch.kernels.fused_gru import ref as gru_ref

    g = torch.Generator(device=dev).manual_seed(1)
    H, G, C = cfg.hidden, cfg.gnn_dim, cfg.cfg_dim
    SF, SL, P = cfg.snap_flows, cfg.snap_links, cfg.max_path

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    entries = {}
    # ---- fused GRU pair, both stages of one event, B = 1
    stages = {"stage1": ("gru1", "gruA", 1 + cfg.flow_feat + C,
                         1 + cfg.link_feat + C),
              "stage2": ("gru2", "gruB", G + C, G + C)}
    gru_tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0,
               "bytes": 0, "max_abs_err": 0.0}
    for stage, (kf, kl, df, dl) in stages.items():
        pf, pl = params[kf], params[kl]
        xf, hf = randn(SF, df), torch.tanh(randn(SF, H))
        xl, hl = randn(SL, dl), torch.tanh(randn(SL, H))
        got = gru_ops.gru_pair(pf, pl, xf, hf, xl, hl)
        want = gru_ref.gru_pair_ref(pf, pl, xf, hf, xl, hl)
        wif, whf = pf["wi"].t().contiguous(), pf["wh"].t().contiguous()
        wil, whl = pl["wi"].t().contiguous(), pl["wh"].t().contiguous()

        def library():
            return (torch.gru_cell(xf, hf, wif, whf, pf["bi"], pf["bh"]),
                    torch.gru_cell(xl, hl, wil, whl, pl["bi"], pl["bh"]))

        lib = library()
        errs = []
        for name, a, b, c in zip(("flow", "link"), got, want, lib):
            check_close(torch, f"fused_gru {stage} {name}", a, b, GRU_TOL)
            check_close(torch, f"torch.gru_cell {stage} {name}", c, b,
                        GRU_TOL)
            errs.append(max_err(torch, a, b))
        flops = sum(2 * r * (d + H) * 3 * H for r, d in ((SF, df), (SL, dl)))
        nbytes = 4 * sum(r * d + 2 * r * H + (d + H) * 3 * H + 6 * H
                         for r, d in ((SF, df), (SL, dl)))
        b_ms, b_by = bound_ms(flops, nbytes)
        row = dict(
            shapes={"flow": [SF, df, H], "link": [SL, dl, H]},
            max_abs_err=max(e[0] for e in errs),
            max_rel_err=max(e[1] for e in errs),
            ms=device_ms(torch, lambda: gru_ops.gru_pair(pf, pl, xf, hf,
                                                         xl, hl)),
            plain_ms=device_ms(torch, lambda: gru_ref.gru_pair_ref(
                pf, pl, xf, hf, xl, hl)),
            library_ms=device_ms(torch, library),
            bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes)
        emit("kernel", name=f"fused_gru_pair/{stage}", **row)
        for k in gru_tot:
            gru_tot[k] = (max(gru_tot[k], row[k]) if k == "max_abs_err"
                          else gru_tot[k] + row[k])
    b_ms, b_by = bound_ms(gru_tot["flops"], gru_tot["bytes"])
    entries["fused_gru_pair"] = dict(
        per="event: stage-1 + stage-2 launch, B=1",
        max_abs_err=gru_tot["max_abs_err"], ms=gru_tot["ms"],
        plain_ms=gru_tot["plain_ms"], bound_ms=b_ms, bound_by=b_by,
        library_ms=gru_tot["library_ms"],
        library="torch.gru_cell, flow + link cell, both stages")

    # ---- the GNN: all gnn_layers rounds of one event in one launch, at
    # B = 1 and B = 4 on uniform random edges, one round alone, and B = 1
    # on the real snapshot with the largest link fan-in
    layers = params["gnn"]
    R = len(layers)
    E = SF * P
    edge_f = torch.arange(SF, device=dev).repeat_interleave(P)
    real = real_snapshot(torch, params, cfg, dev)
    cases = []
    for B in (1, 4):
        edge_l = torch.randint(0, SL, (B, E), generator=g, device=dev)
        edge_mask = (torch.rand(B, E, generator=g, device=dev) < 0.7).float()
        cases.append((f"B{B}", B, edge_l, edge_mask, layers, {}))
    cases.append(("B1_one_round", 1, cases[0][2], cases[0][3], layers[:1],
                  {}))
    cases.append(("B1_real_edges", 1, real["edge_l"], real["edge_mask"],
                  layers, {k: real[k] for k in ("event", "events_scanned")}))
    for tag, B, edge_l, edge_mask, lys, extra in cases:
        f = torch.relu(randn(B, SF, G))
        l = torch.relu(randn(B, SL, G))
        ins = (f, l, edge_f, edge_l, edge_mask)

        def plain(lys=lys, ins=ins):
            f, l, *edges = ins
            for ly in lys:
                f, l = bip_ref.bipartite_round_ref(
                    f, l, *edges, ly["wf"]["w"], ly["wl"]["w"],
                    ly["wf"]["b"], ly["wl"]["b"])
            return f, l

        def plain_matmul(lys=lys, ins=ins):
            f, l, *edges = ins
            m = bip_ref.incidence_from_edges(*edges, SF, SL)
            return bip_ref.bipartite_rounds_matmul(lys, f, l, m)

        def kernel(lys=lys, ins=ins):
            return bip_ops.bipartite_rounds(lys, *ins)

        got, again, want = kernel(), kernel(), plain()
        errs = []
        for name, a, a2, b, c in zip(("flow", "link"), got, again, want,
                                     plain_matmul()):
            check_close(torch, f"bipartite {tag} {name}", a, b, GNN_TOL)
            check_close(torch, f"bipartite matmul form {tag} {name}", c, b,
                        GNN_TOL)
            if not torch.equal(a, a2):
                raise AssertionError(f"bipartite {tag} {name}: two launches "
                                     "differ (the sum order must be fixed)")
            errs.append(max_err(torch, a, b))
        # per round: the products, and the aggregation of the live edges
        live = int((edge_mask != 0).sum().item())
        flops = len(lys) * (B * 2 * (SF + SL) * 2 * G * G + 2 * 2 * live * G)
        nbytes = len(lys) * (4 * B * 2 * (SF + SL) * G
                             + 4 * 2 * (2 * G * G + G) + B * E * (8 + 8 + 4))
        b_ms, b_by = bound_ms(flops, nbytes)
        fanin = torch.zeros(B, SL, device=dev).scatter_add_(
            1, edge_l, (edge_mask != 0).float())
        row = dict(
            shapes={"f": [B, SF, G], "l": [B, SL, G], "E": E},
            rounds=len(lys), live_edges=live,
            max_link_fanin=int(fanin.max().item()), **extra,
            max_abs_err=max(e[0] for e in errs),
            max_rel_err=max(e[1] for e in errs), bitwise_repeat=True,
            ms=device_ms(torch, kernel), plain_ms=device_ms(torch, plain),
            plain_matmul_ms=device_ms(torch, plain_matmul),
            library_ms=None, bound_ms=b_ms, bound_by=b_by)
        emit("kernel", name=f"bipartite_rounds/{tag}", **row)
        if tag == "B1":
            entries["bipartite_round"] = dict(
                per=f"event: {R} rounds in one launch, B=1",
                max_abs_err=row["max_abs_err"], ms=row["ms"],
                plain_ms=row["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                library_ms=None,
                library="none: no single PyTorch call computes a round")
    return entries


def real_snapshot(torch, params, cfg, dev, events=300):
    """The edges of the snapshot with the largest live fan-in of any link
    row over the first `events` events of m4's `run` of the 2000-flow
    sample_scenario(0) at full width, as make_event_step builds them."""
    import numpy as np
    from repro_torch.core import simulate as sim
    from repro_torch.data.traffic import sample_scenario
    from repro_torch.sim import SimRequest

    req = SimRequest.from_scenario(sample_scenario(0))
    static, L, _ = sim.make_static(req.topo, list(req.flows), req.config,
                                   cfg)
    order, times = sim._arrival_order(static)
    st = sim.stack_static([static], dev)
    order = torch.from_numpy(order[None]).long().to(dev)
    times = torch.from_numpy(times[None]).to(dev)
    kept = []
    with torch.inference_mode():
        step = sim.make_event_step(cfg, st, L)
        state = sim.init_sim_state(params, cfg, st, len(req.flows), L)
        ptr = torch.zeros(1, dtype=torch.long, device=dev)
        for _ in range(events):
            state, ptr, *_, snap = sim._open_loop_body(params, step, state,
                                                       ptr, order, times)
            live = (snap["edge_mask"] != 0).float()
            fan = torch.zeros(1, cfg.snap_links, device=dev).scatter_add_(
                1, snap["edge_l"], live).max()
            kept.append((fan, snap["edge_l"], snap["edge_mask"]))
    fans = torch.stack([k[0] for k in kept]).cpu().numpy()
    i = int(np.argmax(fans))
    return {"edge_l": kept[i][1].clone(), "edge_mask": kept[i][2].clone(),
            "max_link_fanin": int(fans[i]), "event": i,
            "events_scanned": events}


def phase_rowmin(torch, dev, run_shape):
    """The water-filling row-min against its plain version, bitwise, at the
    shapes of flowsim_fast's rounds. Returns the entry of `run_shape`."""
    from repro_torch.kernels.waterfill import ops as wf_ops
    from repro_torch.kernels.waterfill import ref as wf_ref

    g = torch.Generator(device=dev).manual_seed(2)
    entry = None
    for B, F, L in ((1, 2000, 80), (1, 2000, 96), (1, 2000, 128),
                    (4, 2000, 96), (1, 129, 37)):
        # 0/1 incidence with 2-4 links per flow, every tenth flow on none;
        # every seventh link's share BIG, as a link with no unfrozen flow
        idx = torch.rand(B, F, L, generator=g, device=dev).argsort(-1)[..., :4]
        k = torch.randint(2, 5, (B, F, 1), generator=g, device=dev)
        a = torch.zeros(B, F, L, device=dev).scatter_(
            -1, idx, (torch.arange(4, device=dev) < k).float())
        a[:, ::10] = 0.0
        share = torch.rand(B, L, generator=g, device=dev) * 1e10 + 1e8
        share[:, ::7] = 1e30
        got = wf_ops.masked_rowmin(a, share)
        want = wf_ref.masked_rowmin_ref(a, share)
        if not torch.equal(got, want):
            raise AssertionError(f"masked_rowmin ({B}, {F}, {L}): the "
                                 "kernel differs from its plain version")
        flops = B * F * L                     # one masked compare per entry
        nbytes = 4 * (B * F * L + B * L + B * F)
        b_ms, b_by = bound_ms(flops, nbytes)
        row = dict(
            shape=[B, F, L], max_abs_err=float((got - want).abs().max()),
            ms=device_ms(torch, lambda: wf_ops.masked_rowmin(a, share)),
            plain_ms=device_ms(torch, lambda: wf_ref.masked_rowmin_ref(
                a, share)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by)
        emit("kernel", name=f"masked_rowmin/B{B}_F{F}_L{L}", **row)
        if (B, F, L) == run_shape:
            entry = dict(
                per=f"launch: one water-filling round, B={B}, F={F}, L={L}",
                max_abs_err=row["max_abs_err"], ms=row["ms"],
                plain_ms=row["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                library_ms=None,
                library="none: no single PyTorch call computes a masked "
                        "row-min")
    if entry is None:
        raise AssertionError(f"no row-min measurement at {run_shape}")
    return entry


def run_counted(torch, fn):
    """Drive fn with every launch counter at 0; return its result, the
    counts it made and its wall time (synchronised)."""
    from repro_torch.kernels.bipartite.ops import bipartite_round
    from repro_torch.kernels.fused_gru.ops import gru_pair
    from repro_torch.kernels.waterfill.ops import masked_rowmin
    torch.cuda.synchronize()
    gru_pair.launches = bipartite_round.launches = 0
    masked_rowmin.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, {"fused_gru_pair": gru_pair.launches,
                 "bipartite_round": bipartite_round.launches,
                 "masked_rowmin": masked_rowmin.launches}, wall


def launches(gru=0, gnn=0, rowmin=0):
    return {"fused_gru_pair": gru, "bipartite_round": gnn,
            "masked_rowmin": rowmin}


def check_fcts(np, results, reqs):
    for res, req in zip(results, reqs):
        f = np.asarray(res.fcts)
        if f.shape != (req.num_flows,):
            raise AssertionError(f"fcts of shape {f.shape}")
        if not (np.isfinite(f).all() and (f > 0).all()):
            raise AssertionError("a flow is not done, or its FCT is not "
                                 "finite and positive")


def phase_full(torch, np, name, backend, req, reqs, want_per_event, smi):
    """`run` of req, then `run_many` of reqs, with the launch counters.
    Returns the result and the counts of the `run`."""
    (res,), counts, wall = run_counted(torch, lambda: [backend.run(req)])
    check_fcts(np, [res], [req])
    events = 2 * req.num_flows
    want = {k: v * events for k, v in want_per_event.items()}
    if counts != want:
        raise AssertionError(f"{name} run: launches {counts}, expected {want}")
    emit("full", path=name, entry="run", flows=req.num_flows, events=events,
         wall_s=wall, events_per_s=events / wall, launches=counts, card=smi)
    run_res, run_launches = res, counts

    results, counts, wall = run_counted(torch, lambda: backend.run_many(reqs))
    check_fcts(np, results, reqs)
    events = 2 * max(r.num_flows for r in reqs)
    want = {k: v * events for k, v in want_per_event.items()}
    if counts != want:
        raise AssertionError(f"{name} run_many: launches {counts}, "
                             f"expected {want}")
    emit("full", path=name, entry="run_many", scenarios=len(reqs),
         events=events, wall_s=wall, events_per_s=events / wall,
         scenario_events_per_s=len(reqs) * events / wall, launches=counts,
         card=smi)
    return run_res, run_launches


def phase_profile(torch, name, backend, req, smi):
    """Where the time goes: one short run under the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        backend.run(req)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    events = 2 * req.num_flows
    top = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)[:8]
    ours = {}
    for e in kernels:
        for k in PORT_KERNELS:
            if k in e.name:
                ours[k] = ours.get(k, 0.0) + e.device_time_total / events
    emit("profile", path=name, flows=req.num_flows, events=events,
         wall_s=wall,
         cuda_kernels_per_event=len(kernels) / events if kernels else None,
         device_busy_share=(busy_us * 1e-6 / wall) if kernels else None,
         device_us_per_event=busy_us / events,
         port_kernel_device_us_per_event=ours,
         top_device_us=[(e.key, e.device_time_total) for e in top],
         card=smi)


def compare_fcts(np, name, gpu, cpu, flows, **extra):
    rel = np.abs(gpu - cpu) / np.abs(cpu)
    emit("cpu", path=name, flows=flows, max_rel_fct_diff=float(rel.max()),
         bitwise_equal=bool(np.array_equal(gpu, cpu)), rtol=FCT_RTOL,
         **extra)
    if not np.allclose(gpu, cpu, rtol=FCT_RTOL, atol=0.0):
        first = int(np.argmax(rel > FCT_RTOL))
        raise AssertionError(f"{name}: card and CPU FCTs differ beyond rtol "
                             f"{FCT_RTOL}: flow {first}, rel {rel[first]}")


def phase_cpu_flowsim_fast(torch, np, req, run_res, dev):
    """flowsim_fast's `run` on the card against the CPU on the same
    scenario; the CPU run records every event, which gives the
    water-filling rounds per event and, should the FCTs differ, the first
    event where a recording run on the card takes another (fid, kind)."""
    from repro_torch.core import flowsim_fast as ff
    packed = [ff._pack(req.topo, list(req.flows))]
    arr = np.array([f.t_arrival for f in req.flows])

    def recorded(d):
        t0 = time.perf_counter()
        fct, log = ff._event_scan_core(*ff._to_device(packed, d),
                                       record=True)
        return (fct.cpu().numpy()[0] - arr,
                {k: v.cpu().numpy()[0] for k, v in log.items()},
                time.perf_counter() - t0)

    c_fct, c_log, c_wall = recorded("cpu")
    first = None
    if not np.allclose(run_res.fcts, c_fct, rtol=FCT_RTOL, atol=0.0):
        _, g_log, _ = recorded(dev)
        same = (g_log["fid"] == c_log["fid"]) \
            & (g_log["is_arrival"] == c_log["is_arrival"])
        first = None if same.all() else int(np.argmin(same))
    rounds, capped = c_log["rounds"], c_log["capped"]
    compare_fcts(
        np, "flowsim_fast", run_res.fcts, c_fct, req.num_flows,
        first_diverging_event=first, cpu_wall_s=c_wall,
        rounds_mean=float(rounds[rounds > 0].mean()),
        rounds_max=int(rounds.max()),
        events_capped_share=float(capped.mean()),
        events_capped=int(capped.sum()), events=int(rounds.size))


def phase_closed_loop(torch, np, m4, fs, cfg, smi):
    """The §5.4 closed loop through run_closed_loop, for m4 and for
    flowsim_fast (whose session is the numpy FlowSimSession)."""
    from repro_torch.core.closedloop import make_backlog
    from repro_torch.net import FatTree, NetConfig
    from repro_torch.sim import run_closed_loop

    topo = FatTree(8, 4, 2)
    backlog = make_backlog(topo, client_racks=2, flows_per_rack=250,
                           size_dist="WebServer", seed=0)
    n = sum(len(rack) for rack in backlog)
    events = 2 * n
    for name, backend, want in (
            ("m4", m4, launches(2 * events, events)),
            ("flowsim_fast", fs, launches())):
        res, counts, wall = run_counted(torch, lambda: run_closed_loop(
            backend, topo, NetConfig(), backlog, 3))
        ct = res.completion_times
        if not (ct.shape == (n,) and np.isfinite(ct).all()
                and (ct > 0).all()):
            raise AssertionError(f"{name} closed loop: a flow did not "
                                 "complete")
        if counts != want:
            raise AssertionError(f"{name} closed loop: launches {counts}, "
                                 f"expected {want}")
        emit("closed_loop", path=name, flows=n, events=events, inflight=3,
             wall_s=wall, wall_ms_per_event=1e3 * wall / events,
             events_per_s=events / wall, makespan_s=res.makespan,
             throughput_flows_per_s=res.throughput, launches=counts,
             card=smi)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.model import M4Config, init_m4
    from repro_torch.data.traffic import sample_scenario
    from repro_torch.kernels import build
    from repro_torch.sim import SimRequest, get_backend
    from repro_torch.weights import params_to

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    card = {"name": kind, "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda}
    emit("card", **card)

    t0 = time.perf_counter()
    build.build_all()
    logs = {}
    for log in sorted(build.build_dir().glob("*.log")):
        logs[log.stem] = [ln.strip() for ln in log.read_text().splitlines()
                          if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0,
         dir=os.path.relpath(build.build_dir(), ROOT), ptxas=logs)

    def req_of(seed, **kw):
        return SimRequest.from_scenario(sample_scenario(seed, **kw))

    dev = torch.device("cuda")
    cfg = M4Config()
    params = init_m4(0, cfg, device=dev)
    entries = phase_kernels(torch, params, cfg, dev)
    fs_req = req_of(1)          # the seed where the 32-round cap binds
    entries["masked_rowmin"] = phase_rowmin(
        torch, dev, (1, fs_req.num_flows, fs_req.topo.num_links))

    # ---- the main paths at full size; warm-ups (cuBLAS handles,
    # allocator pools) are not counted
    m4 = get_backend("m4", params=params, cfg=cfg)
    m4.run(req_of(7, num_flows=20))
    _, run_launches = phase_full(
        torch, np, "m4", m4, req_of(0), [req_of(s) for s in range(4)],
        launches(2, 1), smi)
    fs = get_backend("flowsim_fast")
    fs.run(req_of(7, num_flows=20))
    fs_res, fs_launches = phase_full(
        torch, np, "flowsim_fast", fs, fs_req, [req_of(s) for s in range(4)],
        launches(rowmin=32), smi)
    run_launches["masked_rowmin"] = fs_launches["masked_rowmin"]

    # ---- where the time goes: one short run of each path
    phase_profile(torch, "m4", m4, req_of(3, num_flows=100), smi)
    phase_profile(torch, "flowsim_fast", fs, req_of(3, num_flows=50), smi)

    # ---- the card against the CPU
    creq = req_of(5, num_flows=200)
    gpu = m4.run(creq)
    cpu = get_backend("m4", params=params_to(params, "cpu"), cfg=cfg,
                      device="cpu").run(creq)
    compare_fcts(np, "m4", gpu.fcts, cpu.fcts, creq.num_flows)
    phase_cpu_flowsim_fast(torch, np, fs_req, fs_res, dev)

    phase_closed_loop(torch, np, m4, fs, cfg, smi)

    sources = {"fused_gru_pair": ("src/repro_torch/kernels/csrc/fused_gru.cu",
                                  "src/repro/kernels/fused_gru/kernel.py:21"),
               "bipartite_round": ("src/repro_torch/kernels/csrc/bipartite.cu",
                                   "src/repro/kernels/bipartite/kernel.py:27"),
               "masked_rowmin": ("src/repro_torch/kernels/csrc/waterfill.cu",
                                 "src/repro/kernels/waterfill/kernel.py:21")}
    line = []
    for name, e in entries.items():
        src, replaces = sources[name]
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": run_launches[name],
                     **e})
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
