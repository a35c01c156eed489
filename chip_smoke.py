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
                 shape, bitwise; the per-event water-filling at 2000 flows
                 and 80/96/128 links, B = 4 padded, 60000 flows (its
                 device-memory placement) and the real states with the
                 most rounds and the most active flows over the first 1000
                 events of flowsim_fast's `run`, bitwise against its plain
                 version and a second launch): errors, device times (CUDA-graph replay,
                 so host overhead is excluded), bound, library call;
4. full        — m4 at the paper's full width (M4Config defaults, seeded
                 random weights): `run` of one 2000-flow Table-2 scenario,
                 then `run_many` of four, through get_backend("m4"); then
                 flowsim_fast the same way (2000 flows, `run` of the seed
                 where the 32-round water-filling cap binds). Each through
                 the compiled loop (one CUDA graph of the event step per
                 arena shape: a capture on the first call, replays on a
                 second) and through the eager loop of the same requests:
                 FCTs bitwise, one capture then none (TRACE_COUNTS), the
                 graph pool's bytes, events/s of both back to back. Every
                 flow done, FCTs finite and positive, and the launch
                 counters show each path's kernels (m4: 2 GRU-pair
                 launches and 1 GNN launch per event; flowsim_fast: 1
                 water-filling launch per event and no row-min), the
                 replays' counts exactly the eager loop's;
5. profile     — m4 on a 100-flow scenario and flowsim_fast's 2000-flow
                 `run` under torch.profiler: device busy share (for
                 flowsim_fast also against its unprofiled `run`), CUDA
                 kernels launched per event, and the device time per
                 event of each of the port's kernels;
6. cpu         — the card against the CPU: m4 with the same weights on a
                 200-flow scenario, flowsim_fast on the 2000-flow `run`
                 scenario, FCTs at rtol 1e-4 (for flowsim_fast also a
                 recording run on the card, counted: its per-event
                 records (fid, kind, rounds, capped) against the CPU's,
                 and the first event where they differ); both CPU runs
                 also record probes, for phase 8;
7. closed_loop — the §5.4 closed loop (per-rack inflight 3) on a 2-client-
                 rack backlog of 500 flows through run_closed_loop, for m4
                 at full width, for flowsim_fast and for the packet DES
                 (on the host): every flow completes, m4's launch
                 counters read 2 GRU-pair launches and 1 GNN launch per
                 event, the other two launch nothing;
8. probes      — the probed paths at full width, each a request with
                 ProbeConfig(stride 4, ring 256): m4's `run` of the full
                 phase's 2000-flow scenario (captured, 4 events per
                 replay, against its eager loop bitwise, rings too; FCTs
                 bitwise as unprobed, 2
                 GRU-pair and 1 GNN launch per event, the ring wrapped:
                 the last 256 of 1000 samples, in order, valid and
                 finite; events/s against the unprobed `run` just before
                 it); `run_many` of four scenarios of 200-500 flows, each
                 series trimmed to its flows and links and within rtol
                 1e-5 of its own probed `run`; flowsim_fast's 2000-flow
                 `run` (FCTs bitwise, water-filling launches = events +
                 stride hits); the card's series against the CPU's of
                 phase 6 (m4 at rtol 1e-4, flowsim_fast bitwise); then
                 the divergence observatory, traced: `diff_sweep` of m4
                 at full width against the packet DES over smoke16's
                 first 8 specs with probes on both sides, run twice (the
                 second's FCT passes all cache hits, so only its probed
                 m4 pass launches), and `python -m repro_torch.obs
                 --check` over the spans and the 16 probe files;
9. train       — m4's training path at full width: the packet DES on two
                 Table-2 scenario specs, cut from 2000 to TRAIN_FLOWS =
                 1000 flows (K = 2000 events each) to keep the phase near
                 three minutes, and their event tensors (build_dataset); `fit` per sim (one
                 epoch, two updates, the TrainConfig defaults) with
                 seconds per update, teacher-forced events/s, peak device
                 memory, each head's loss and the grad norm; one backward
                 (200 events) in which every parameter leaf gets a
                 finite, non-zero gradient; its forward and backward per
                 event, timed and profiled (40 events); batch mode (both
                 sims cut to 1000 events, one update); one update on the
                 card against the CPU (200 events); resume from a
                 checkpoint against an uninterrupted run, bitwise;
                 `evaluate_m4` of the trained weights on a held-out
                 2000-flow scenario spec (packet ground truth, numpy
                 flowSim, m4 on the card). The GRU and GNN counters stay
                 at 0 through every differentiated step (they take the
                 plain versions by the keyword plain=True) and read 2 and
                 1 per event in the evaluation;
10. sweep      — the sweep engine and the one-call pipeline: smoke16 at
                 SWEEP_FLOWS = 200 (16 specs of 200-260 flows, four
                 topologies and four workload families) through
                 SweepRunner at chunk 8 for m4 (full width) and
                 flowsim_fast: 2 chunks padded to B = 8, launch counters
                 (2 GRU-pair and 1 GNN, or 1 water-filling, per batched
                 event), a re-run all hits, bitwise, with no launch, two
                 specs of each chunk against the CPU, and a profile of one
                 B = 8 chunk (smoke16 at its own 30-58 flows); then `python -m
                 repro_torch.train` in-process at paper width (2 Table-2
                 sims and 2 Table-3 eval specs of CLI_FLOWS = 500 flows,
                 one epoch), run twice: the second a finished resume with
                 the same weights hash, all dataset and ground-truth
                 hits, and only the evaluation's m4 launching kernels;
11. fleet      — the fault-tolerant fleet on the card: smoke16 at
                 SWEEP_FLOWS through SweepRunner(fleet=FleetConfig(
                 workers=2)) at chunk FLEET_CHUNK = 4 (4 tasks), for m4
                 at full width and for flowsim_fast, each into a fresh
                 cache and against an in-process SweepRunner at the same
                 chunk: cache bytes and entries bitwise, the workers'
                 launches (brought back by `CountedJob`) equal to the
                 in-process ones, the fingerprint `-kcuda`, 2 workers
                 spawned, no JAX in a worker, and for m4 the two workers'
                 tasks overlapping in time (two CUDA contexts launching
                 the GNN at once); flowsim_fast under FLEET_CHAOS (kills,
                 a corrupt blob, a transient OSError) converging bitwise
                 to the clean fleet's cache; a relaunch that spawns 0
                 and a re-run all hits; m4 with diff_against=flowsim_fast
                 over the cache holding the oracle's entries, traced: 16
                 divergence stamps over 4 tasks and `python -m
                 repro_torch.obs --check --coord` exit 0. Walls, each
                 worker's spawn-to-first-claim and first-task times, the
                 FleetMetrics dicts;
12. serve      — the simulation service at full width: SimService with
                 lanes m4 (batch 8) and flowsim_fast (batch 4) behind the
                 HTTP front-end on an ephemeral port; 4 client threads,
                 each with its 8 requests in flight at once, post
                 8 unique Table-2 specs in each of 2 shape buckets (500
                 and 2000 flows, the 8-rack fat tree at 4-to-1) to both
                 lanes, then all again. Every reply bitwise as `run_many`
                 of its padded batch; one capture per bucket per lane, no
                 retrace budget broken; the second round all cache hits
                 with no launch and no capture; /metrics and /healthz;
                 a drained close resolves a part bucket; a second service
                 with no cache replays the captured programs (0
                 captures). Requests/s, p50/p99 latency and queue delay.

Then the `kernels` line (each kernel's launches on the full-size `run`,
on the probed `run`s, in the train phase's evaluation, in the sweeps, in
the workers of the fleet phase's two clean fleets and in the serve
phase's first round), the card's nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed check raises, so the script
exits nonzero and prints no result; so it does with no CUDA device, or
when run outside the repository. Imports nothing of JAX. The fleet's
spawned workers import this file as `__mp_main__`, so everything that
runs work stays under the `__main__` check.
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
                "masked_rowmin_kernel", "waterfill_event_kernel")
GRU_TOL = 1e-5
GNN_TOL = 1e-4
FCT_RTOL = 1e-4
TRAIN_FLOWS = 1000     # flows of the train phase's sims (see phase_train)
SWEEP_FLOWS = 200      # smoke16's base flow count in the sweep phase
CLI_FLOWS = 500        # flows of the training CLI's sims (sweep phase)
PROBE_STRIDE = 4       # probes phase: a sample every 4 events ...
PROBE_SAMPLES = 256    # ... into a ring of 256, which wraps at 2000 flows
PROBE_RTOL = 1e-5      # a batched series against its scenario's own run
SERVE_FLOWS = (500, 2000)  # serve phase: one shape bucket per flow count
SERVE_UNIQUE = 8           # ... holding 8 unique specs each
FLEET_CHUNK = 4            # fleet phase: smoke16 in 4 tasks of 4 specs
# a worker-targeted fault fires only in a worker that claims a task, so
# the kill targets both workers of the pool: the first to claim dies
FLEET_CHAOS = ("kill:worker=0,after=1;kill:worker=1,after=1;"
               "corrupt:task=1;raise:task=2,exc=oserror,times=1")


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


def event_bound(lists, rounds, nnz):
    """Bound of one waterfill_event launch (ms, "bytes"|"operations"):
    bytes = each input of the function once, the incidence in one encoding
    (flow_links, 4 B N K), cap (4 B L) and active (B N), and each output
    once (rates 4 B N, rounds 4 B, capped B); the kernel's own indices
    (link_ptr, flow_entries) belong to its design, not to the function,
    and are not counted. operations = sum over scenarios of rounds_b x
    (2 nnz_b + 3 L + 2 N): per round a link-sum add or count per list
    entry, a row-min compare per flow-link entry, a subtract, clamp and
    divide per link, and theta's min and the tie compare per flow, all at
    the fp32 rate."""
    B, N, K = lists.flow_links.shape
    L = lists.link_ptr.shape[1] - 1
    nbytes = 4 * B * N * K + 4 * B * L + B * N + 4 * B * N + 4 * B + B
    ops = sum(int(r) * (2 * int(z) + 3 * L + 2 * N)
              for r, z in zip(rounds.tolist(), nnz.tolist()))
    return bound_ms(ops, nbytes) + (ops, nbytes)


def flowsim_states(torch, np, dev, req, events=1000):
    """The states (active sets) that the water-filling of the first
    `events` events of flowsim_fast's `run` of req sees on the card: the
    one with the most rounds and the one with the most active flows."""
    from repro_torch.core import flowsim_fast as ff
    args = ff._to_device([ff._pack(req.topo, list(req.flows))], dev)
    _, log = ff._event_scan_core(*args, num_events=events, record=True)
    fid = log["fid"][0].cpu().numpy()
    is_arr = log["is_arrival"][0].cpu().numpy()
    rounds = log["rounds"][0].cpu().numpy()
    active = np.zeros(req.num_flows, bool)
    states = []
    for e in range(events):
        states.append(active.copy())
        active[fid[e]] = is_arr[e]
    counts = np.array([st.sum() for st in states])
    picks = {"most_rounds": int(np.argmax(rounds)),
             "most_active": int(np.argmax(counts))}
    return args[0], args[1], {
        tag: (e, torch.from_numpy(states[e])[None].to(dev), int(rounds[e]),
              int(counts[e])) for tag, e in picks.items()}


def event_case(torch, g, dev, B, N, L, real=None):
    """Random incidence as the main path holds it: 2-4 links per flow,
    every seventh flow on none and inactive (an active flow with no link
    is never frozen: only padded flows have none), capacities 1-10 Gb/s,
    70% of the flows active; `real` pads scenario b past its (n flows, l
    links), and some padded flows are active, as late in run_many."""
    idx = torch.rand(B, N, L, generator=g, device=dev).argsort(-1)[..., :4]
    k = torch.randint(2, 5, (B, N, 1), generator=g, device=dev)
    a = torch.zeros(B, N, L, device=dev).scatter_(
        -1, idx, (torch.arange(4, device=dev) < k).float())
    a[:, ::7] = 0.0
    cap = torch.rand(B, L, generator=g, device=dev) * 9e9 + 1e9
    active = torch.rand(B, N, generator=g, device=dev) < 0.7
    active[:, ::7] = False
    for b, (n, l) in enumerate(real or ()):
        a[b, n:] = 0.0
        a[b, :, l:] = 0.0
        cap[b, l:] = 1.0
    return a, cap, active


def phase_event(torch, np, dev, req):
    """The per-event water-filling against its plain version, bitwise (rates,
    rounds, capped), and against a second launch. Returns the entry of
    the real state with the most rounds."""
    from repro_torch.kernels.waterfill import layout as wf_layout
    from repro_torch.kernels.waterfill import ops as wf_ops
    from repro_torch.kernels.waterfill import ref as wf_ref

    g = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for B, N, L in ((1, 2000, 80), (1, 2000, 96), (1, 2000, 128)):
        cases.append((f"B{B}_N{N}_L{L}", *event_case(torch, g, dev, B, N, L),
                      {}))
    cases.append(("B4_padded", *event_case(
        torch, g, dev, 4, 2000, 128,
        real=[(2000, 96), (1200, 80), (600, 128), (1900, 80)]), {}))
    cases.append(("B1_N60000_L128", *event_case(torch, g, dev, 1, 60000,
                                                128), {}))
    a_real, cap_real, picks = flowsim_states(torch, np, dev, req)
    for tag, (e, act, _, n) in picks.items():
        cases.append((f"real_{tag}", a_real, cap_real, act,
                      {"event": e, "events_scanned": 1000, "active": n}))
    entry = None
    for tag, a, cap, active, extra in cases:
        lists = wf_layout.incidence_lists(a)
        a64 = a.double()
        B, N, L = a.shape

        def kernel(lists=lists, cap=cap, active=active):
            return wf_ops.waterfill_event(lists, cap, active)

        def plain(a64=a64, cap=cap, active=active):
            return wf_ref.waterfill_event_ref(a64, cap, active)

        got, again, want = kernel(), kernel(), plain()
        for name, x, x2, w in zip(("rates", "rounds", "capped"), got, again,
                                  want):
            if not torch.equal(x, w):
                raise AssertionError(f"waterfill_event {tag} {name}: the "
                                     "kernel differs from its plain version")
            if not torch.equal(x, x2):
                raise AssertionError(f"waterfill_event {tag} {name}: two "
                                     "launches differ")
        rounds = want[1]
        nnz = lists.link_ptr[:, -1]
        b_ms, b_by, ops, nbytes = event_bound(lists, rounds, nnz)
        smem, scratch = wf_layout.plan(N, L, lists.flow_links.shape[2],
                                       lists.nnz)
        row = dict(
            shape=[B, N, L], K=lists.flow_links.shape[2],
            nnz=nnz.tolist(), rounds=rounds.tolist(),
            capped=want[2].tolist(),
            placement="shared memory" if smem else "device memory",
            smem_bytes=smem, scratch_bytes=scratch, **extra,
            max_abs_err=float((got[0] - want[0]).abs().max()),
            bitwise=True, bitwise_repeat=True,
            ms=device_ms(torch, kernel),
            plain_ms=device_ms(torch, plain, reps=5),
            library_ms=None, bound_ms=b_ms, bound_by=b_by, ops=ops,
            bytes=nbytes)
        emit("kernel", name=f"waterfill_event/{tag}", **row)
        if tag == "real_most_rounds":
            entry = dict(
                per=f"event: up to 32 rounds in one launch, B=1, N={N}, "
                    f"L={L}, the real state with the most rounds "
                    f"({int(rounds[0])}) over the first 1000 events",
                max_abs_err=row["max_abs_err"], ms=row["ms"],
                plain_ms=row["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                library_ms=None,
                library="none: no single PyTorch call computes a "
                        "water-filling")
    return entry


def launch_counters():
    """The four kernel wrappers, by the names of the `kernels` line."""
    from repro_torch.kernels.bipartite.ops import bipartite_round
    from repro_torch.kernels.fused_gru.ops import gru_pair
    from repro_torch.kernels.waterfill.ops import (masked_rowmin,
                                                   waterfill_event)
    return {"fused_gru_pair": gru_pair, "bipartite_round": bipartite_round,
            "masked_rowmin": masked_rowmin,
            "waterfill_event": waterfill_event}


def run_counted(torch, fn):
    """Drive fn with every launch counter at 0; return its result, the
    counts it made and its wall time (synchronised)."""
    counters = launch_counters()
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, {k: f.launches for k, f in counters.items()}, wall


class CountedJob:
    """A fleet job that runs `inner` (a `SweepJob`) and appends one JSON
    line per task it ran to `<out_dir>/<pid>.jsonl`: the kernel launches
    the task made in its worker process, the seconds the worker took to
    build its backend (CUDA context, weights onto the card) before its
    first task, the task's wall, and the top-level packages of JAX or
    of the JAX package in the worker's `sys.modules`. It lives at module
    level because spawned workers unpickle it from this file, which
    they import as `__mp_main__`."""

    def __init__(self, inner, out_dir):
        self.inner, self.out_dir = inner, out_dir

    @property
    def device(self):
        return self.inner.device

    def run(self, payload):
        import torch
        t0 = time.time()
        first = getattr(self.inner, "_backend_obj", None) is None
        self.inner._backend()
        t1 = time.time()
        counters = launch_counters()
        before = {k: f.launches for k, f in counters.items()}
        self.inner.run(payload)
        torch.cuda.synchronize()
        t2 = time.time()
        rec = {"pid": os.getpid(), "first": first, "t_start": t0,
               "backend_s": t1 - t0, "run_s": t2 - t1, "t_end": t2,
               "keys": list(payload["keys"]),
               "launches": {k: f.launches - before[k]
                            for k, f in counters.items()},
               "jax_modules": sorted({m.split(".")[0] for m in sys.modules
                                      if m.split(".")[0] in
                                      ("jax", "jaxlib", "repro")})}
        os.makedirs(self.out_dir, exist_ok=True)
        with open(os.path.join(self.out_dir, f"{os.getpid()}.jsonl"),
                  "a") as f:
            f.write(json.dumps(rec) + "\n")

    def verify(self, payload):
        return self.inner.verify(payload)

    def result_paths(self, payload):
        return self.inner.result_paths(payload)

    def done_extra(self, payload):
        return self.inner.done_extra(payload)


def launches(gru=0, gnn=0, rowmin=0, event=0):
    return {"fused_gru_pair": gru, "bipartite_round": gnn,
            "masked_rowmin": rowmin, "waterfill_event": event}


def check_fcts(np, results, reqs):
    for res, req in zip(results, reqs):
        f = np.asarray(res.fcts)
        if f.shape != (req.num_flows,):
            raise AssertionError(f"fcts of shape {f.shape}")
        if not (np.isfinite(f).all() and (f > 0).all()):
            raise AssertionError("a flow is not done, or its FCT is not "
                                 "finite and positive")


def trace_counts(name):
    """The TRACE_COUNTS family of a backend's event loop."""
    from repro_torch.core import flowsim_fast, simulate
    return (simulate if name == "m4" else flowsim_fast).TRACE_COUNTS


def same_result(np, a, b):
    """FCTs and, where present, probe rings bitwise equal."""
    if np.asarray(a.fcts).tobytes() != np.asarray(b.fcts).tobytes():
        return False
    if a.probes is None or b.probes is None:
        return a.probes is b.probes
    return all(a.probes[k].tobytes() == b.probes[k].tobytes()
               for k in ("t", "ev")) and all(
        v.tobytes() == b.probes["channels"][ch].tobytes()
        for ch, v in a.probes["channels"].items())


def captured_vs_eager(torch, np, name, call, want, label):
    """Drive `call` through the captured loop twice (the first call
    captures the entry's graphs, the second only replays), then through
    the eager loop (`compiled.eager()`): every result bitwise equal,
    launch counts `want` each time, one capture then none. Returns the
    first captured call's results and counts, and the measurements."""
    from repro_torch.core import compiled
    tc = trace_counts(name)
    c0 = sum(tc.values())
    res, counts, wall = run_counted(torch, call)
    c1 = sum(tc.values())
    again, counts2, wall2 = run_counted(torch, call)
    c2 = sum(tc.values())
    entry = compiled.entries()[-1]
    with compiled.eager():
        eager, ecounts, ewall = run_counted(torch, call)
    if sum(tc.values()) != c2:
        raise AssertionError(f"{label}: the eager loop counted a compile")
    if not counts == counts2 == ecounts == want:
        raise AssertionError(f"{label}: launches {counts} / {counts2} / "
                             f"eager {ecounts}, expected {want}")
    if (c1 - c0, c2 - c1) != (1, 0):
        raise AssertionError(f"{label}: captures {c1 - c0} then {c2 - c1}, "
                             "expected 1 then 0")
    if not all(same_result(np, a, b) and same_result(np, a, e)
               for a, b, e in zip(res, again, eager)):
        raise AssertionError(f"{label}: captured and eager loops differ")
    return res, counts, {
        "capture_call_wall_s": wall, "wall_s": wall2, "eager_wall_s": ewall,
        "captures_first_call": c1 - c0, "captures_repeat_call": c2 - c1,
        "graphs": entry["graphs"], "pool_bytes": entry["pool_bytes"],
        "buffer_bytes": entry["buffer_bytes"], "bitwise_eager": True}


def phase_full(torch, np, name, backend, req, reqs, want_per_event, smi):
    """`run` of req, then `run_many` of reqs, through the captured loop
    (the main path) and against the eager loop of the same requests
    (`captured_vs_eager`), with events/s of both taken back to back.
    Returns the captured `run`'s result, launch counts and events/s."""
    out = None
    for entry, call, events in (
            ("run", lambda: [backend.run(req)], 2 * req.num_flows),
            ("run_many", lambda: backend.run_many(reqs),
             2 * max(r.num_flows for r in reqs))):
        want = {k: v * events for k, v in want_per_event.items()}
        results, counts, m = captured_vs_eager(
            torch, np, name, call, want, f"{name} {entry}")
        check_fcts(np, results, [req] if entry == "run" else reqs)
        rate = events / m["wall_s"]
        emit("full", path=name, entry=entry,
             flows=[r.num_flows for r in ([req] if entry == "run"
                                          else reqs)],
             events=events, events_per_s=rate,
             events_per_s_capture_call=events / m["capture_call_wall_s"],
             eager_events_per_s=events / m["eager_wall_s"],
             captured_over_eager=m["eager_wall_s"] / m["wall_s"],
             scenario_events_per_s=len(results) * rate, launches=counts,
             **m, card=smi)
        if out is None:
            out = (results[0], counts, rate)
    return out


def phase_profile(torch, name, backend, req, smi, events_per_s=None):
    """Where the time goes: one run under the profiler (`req`, or a list
    of requests for one padded `run_many`, whose events are batched
    events). With the events/s of the same run unprofiled, also the busy
    share it implies (device time per event x events/s), free of the
    profiler's own host cost."""
    reqs = req if isinstance(req, list) else [req]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # a call before the window, so that it holds replays of the captured
    # loop and no capture
    backend.run_many(reqs) if isinstance(req, list) else backend.run(req)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        backend.run_many(reqs) if isinstance(req, list) else backend.run(req)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    events = 2 * max(r.num_flows for r in reqs)
    top = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)[:8]
    ours = {}
    for e in kernels:
        for k in PORT_KERNELS:
            if k in e.name:
                ours[k] = ours.get(k, 0.0) + e.device_time_total / events
    emit("profile", path=name, flows=[r.num_flows for r in reqs],
         scenarios=len(reqs), events=events,
         wall_s=wall,
         cuda_kernels_per_event=len(kernels) / events if kernels else None,
         device_busy_share=(busy_us * 1e-6 / wall) if kernels else None,
         events_per_s_unprofiled=events_per_s,
         device_busy_share_unprofiled=(busy_us * 1e-6 / events * events_per_s
                                       if events_per_s else None),
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


def phase_cpu_flowsim_fast(torch, np, req, run_res, dev, probes):
    """flowsim_fast's `run` on the card against the CPU on the same
    scenario; both runs record every event (the card's counted: one
    water-filling launch per event), which gives the water-filling rounds
    per event and the first event whose records (fid, kind, rounds,
    capped) differ, if any. The CPU's run also records `probes`, for the
    probes phase; returns its series."""
    from repro_torch.core import flowsim_fast as ff
    from repro_torch.core.probes import (FLOWSIM_CHANNELS, buffers_numpy,
                                         normalize_probes)
    probes = normalize_probes(probes, FLOWSIM_CHANNELS)
    flows = list(req.flows)
    packed = [ff._pack(req.topo, flows)]
    arr = np.array([f.t_arrival for f in req.flows])

    def recorded(d, probes=None):
        t0 = time.perf_counter()
        out = ff._event_scan_core(*ff._to_device(packed, d), record=True,
                                  probes=probes)
        series = None
        if probes is not None:
            bufs = {k: v[0] for k, v in buffers_numpy(out[2]).items()}
            series = ff._finalize_fs_series(
                probes, bufs, req.topo, flows, num_flows=len(flows),
                num_links=req.topo.num_links)
        return (out[0].cpu().numpy()[0] - arr,
                {k: v.cpu().numpy()[0] for k, v in out[1].items()},
                time.perf_counter() - t0, series)

    c_fct, c_log, c_wall, c_series = recorded("cpu", probes)
    (g_fct, g_log, _, _), counts, _ = run_counted(torch,
                                                  lambda: recorded(dev))
    events = 2 * req.num_flows
    if counts != launches(event=events):
        raise AssertionError(f"flowsim_fast recorded run: launches {counts}, "
                             f"expected {launches(event=events)}")
    same = np.ones(events, bool)
    for k in ("fid", "is_arrival", "rounds", "capped"):
        same &= g_log[k] == c_log[k]
    first = None if same.all() else int(np.argmin(same))
    rounds, capped = c_log["rounds"], c_log["capped"]
    compare_fcts(
        np, "flowsim_fast", run_res.fcts, c_fct, req.num_flows,
        first_diverging_event=first, records_equal=bool(same.all()),
        recorded_run_bitwise_equal=bool(np.array_equal(g_fct, c_fct)),
        recorded_run_launches=counts, cpu_wall_s=c_wall,
        rounds_mean=float(rounds[rounds > 0].mean()),
        rounds_max=int(rounds.max()),
        events_capped_share=float(capped.mean()),
        events_capped=int(capped.sum()), events=int(rounds.size),
        cpu_probes=f"stride {probes.stride}, ring {probes.max_samples}")
    return c_series


def phase_closed_loop(torch, np, m4, fs, cfg, smi):
    """The §5.4 closed loop through run_closed_loop, for m4, for
    flowsim_fast (whose session is the numpy FlowSimSession) and for the
    packet DES (PacketSession, on the host)."""
    from repro_torch.core.closedloop import make_backlog
    from repro_torch.net import FatTree, NetConfig
    from repro_torch.sim import get_backend, run_closed_loop

    topo = FatTree(8, 4, 2)
    backlog = make_backlog(topo, client_racks=2, flows_per_rack=250,
                           size_dist="WebServer", seed=0)
    n = sum(len(rack) for rack in backlog)
    events = 2 * n
    for name, backend, want in (
            ("m4", m4, launches(2 * events, events)),
            ("flowsim_fast", fs, launches()),
            ("packet", get_backend("packet"), launches())):
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


def series_close(np, name, got, want, rtol):
    """A probe series against another: `ev` equal, `t` at rtol, each
    channel at rtol relative to the value and to the channel's largest
    magnitude (a channel holds exact zeros beside values of its scale).
    Returns the largest relative difference over the channels."""
    if got["ev"].tolist() != want["ev"].tolist():
        raise AssertionError(f"{name}: sampled events differ")
    if not np.allclose(got["t"], want["t"], rtol=rtol, atol=0.0):
        raise AssertionError(f"{name}: sample times differ beyond {rtol}")
    worst = 0.0
    for ch, w in want["channels"].items():
        g = got["channels"][ch]
        scale = float(np.abs(w).max()) if w.size else 0.0
        if g.shape != w.shape or not np.allclose(g, w, rtol=rtol,
                                                 atol=rtol * scale):
            raise AssertionError(f"{name}: channel {ch} differs beyond "
                                 f"rtol {rtol}")
        if w.size:
            worst = max(worst, float((np.abs(g - w)
                                      / np.maximum(np.abs(w), 1e-30)).max()))
    return worst


def ring_bytes(series, batch=1):
    """Device bytes of the ring buffers behind one series: t (float32) and
    ev (int32) per slot, and one float32 per entity per channel."""
    S = series["max_samples"]
    dims = sum(v.shape[1] for v in series["channels"].values())
    return batch * S * (4 + 4 + 4 * dims)


def check_probed(np, name, series, events, probes, channels,
                 batched_events=None):
    """A probed run's series: the ring holds the last `max_samples` stride
    hits in order, validates, and every value is finite. In a padded
    batch of `batched_events`, a scenario's own events are its first
    `events`; the samples of the rest are dropped."""
    from repro_torch.obs import validate_series
    hits = -(-events // probes.stride)
    kept = list(range(0, batched_events or events, probes.stride))
    kept = [k for k in kept[-probes.max_samples:] if k < events]
    if series["ev"].tolist() != kept:
        raise AssertionError(f"{name}: ring holds events "
                             f"{series['ev'][:3]}..{series['ev'][-3:]}, "
                             f"expected the last {len(kept)} of {hits} hits")
    problems = validate_series(series)
    if problems:
        raise AssertionError(f"{name}: {problems}")
    if tuple(series["channels"]) != channels:
        raise AssertionError(f"{name}: channels {list(series['channels'])}")
    for ch, v in series["channels"].items():
        if not np.isfinite(v).all():
            raise AssertionError(f"{name}: channel {ch} not finite")
    return hits


def phase_probes(torch, np, m4, fs, base, smi):
    """The probed paths at full width (ring-buffer probes of m4 and
    flowsim_fast through SimRequest.probes), the card against the CPU's
    probed runs of the cpu phase, and the divergence observatory: m4
    against the packet DES over smoke16's first 8 specs with probes on
    both sides, traced, then re-run from the cache. `base` holds the
    unprobed results and rates of the full phase and the CPU series.
    Returns the probed runs' launch counts."""
    import contextlib
    import dataclasses
    import tempfile
    from repro_torch.core.probes import (FLOWSIM_CHANNELS, M4_CHANNELS,
                                         ProbeConfig)
    from repro_torch.obs import configure, get_registry
    from repro_torch.obs import diff as obs_diff
    from repro_torch.obs.__main__ import main as obs_main
    from repro_torch.scenarios import get_suite
    from repro_torch.sim import get_backend

    t_phase = time.perf_counter()
    probes = ProbeConfig(stride=PROBE_STRIDE, max_samples=PROBE_SAMPLES)
    total = launches()

    # ---- m4 `run`, probed, against the full phase's unprobed `run`
    req = dataclasses.replace(base["m4_req"], probes=probes)
    events = 2 * req.num_flows
    # the unprobed `run` again just before, for a rate taken back to back
    _, _, un_wall = run_counted(torch, lambda: m4.run(base["m4_req"]))
    # the probed entry's capture, a replay, and the eager loop: bitwise
    (res,), counts, m = captured_vs_eager(
        torch, np, "m4", lambda: [m4.run(req)], launches(2 * events, events),
        "m4 probed run")
    wall = m["wall_s"]
    if res.fcts.tobytes() != base["m4_res"].fcts.tobytes():
        raise AssertionError("m4 probed run: FCTs differ from unprobed")
    hits = check_probed(np, "m4 probed run", res.probes, events, probes,
                        M4_CHANNELS)
    for k, v in counts.items():
        total[k] += v
    emit("probes", path="m4", entry="run", flows=req.num_flows,
         events=events, stride=probes.stride, hits=hits,
         samples=len(res.probes["ev"]), last_ev=int(res.probes["ev"][-1]),
         ring_bytes=ring_bytes(res.probes), events_per_s=events / wall,
         unprobed_events_per_s=events / un_wall,
         probed_over_unprobed=un_wall / wall,
         full_phase_unprobed_events_per_s=base["m4_rate"],
         eager_events_per_s=events / m["eager_wall_s"],
         fcts_bitwise_unprobed=True, launches=counts, **m, card=smi)

    # ---- m4 `run_many`, probed: each series trimmed to its scenario and
    # equal to that scenario's own probed `run`
    reqs = [dataclasses.replace(r, probes=probes) for r in base["m4_many"]]
    events = 2 * max(r.num_flows for r in reqs)
    results, counts, wall = run_counted(torch, lambda: m4.run_many(reqs))
    if counts != launches(2 * events, events):
        raise AssertionError(f"m4 probed run_many: launches {counts}")
    worst = 0.0
    for r, got in zip(reqs, results):
        s = got.probes
        if s["channels"]["flow_remaining"].shape[1] != r.num_flows or \
                s["channels"]["link_queue"].shape[1] != r.topo.num_links:
            raise AssertionError("m4 probed run_many: series not trimmed "
                                 "to its scenario")
        check_probed(np, "m4 probed run_many", s, 2 * r.num_flows, probes,
                     M4_CHANNELS, batched_events=events)
        worst = max(worst, series_close(np, "m4 run_many vs run", s,
                                        m4.run(r).probes, PROBE_RTOL))
    emit("probes", path="m4", entry="run_many", scenarios=len(reqs),
         flows=[r.num_flows for r in reqs],
         links=[r.topo.num_links for r in reqs], events=events,
         wall_s=wall, events_per_s=events / wall,
         max_rel_diff_vs_own_run=worst, rtol=PROBE_RTOL, launches=counts,
         card=smi)

    # ---- flowsim_fast `run`, probed: one more water-filling per hit
    req = dataclasses.replace(base["fs_req"], probes=probes)
    events = 2 * req.num_flows
    _, _, un_wall = run_counted(torch, lambda: fs.run(base["fs_req"]))
    hits = -(-events // probes.stride)
    (res,), counts, m = captured_vs_eager(
        torch, np, "flowsim_fast", lambda: [fs.run(req)],
        launches(event=events + hits), "flowsim_fast probed run")
    wall = m["wall_s"]
    if check_probed(np, "flowsim_fast probed run", res.probes, events,
                    probes, FLOWSIM_CHANNELS) != hits:
        raise AssertionError("flowsim_fast probed run: stride hits")
    if res.fcts.tobytes() != base["fs_res"].fcts.tobytes():
        raise AssertionError("flowsim_fast probed run: FCTs differ from "
                             "unprobed")
    for k, v in counts.items():
        total[k] += v
    fs_series = res.probes
    emit("probes", path="flowsim_fast", entry="run", flows=req.num_flows,
         events=events, stride=probes.stride, hits=hits,
         samples=len(fs_series["ev"]), last_ev=int(fs_series["ev"][-1]),
         ring_bytes=ring_bytes(fs_series), events_per_s=events / wall,
         unprobed_events_per_s=events / un_wall,
         probed_over_unprobed=un_wall / wall,
         full_phase_unprobed_events_per_s=base["fs_rate"],
         waterfill_event_added_by_flow_rate=hits,
         eager_events_per_s=events / m["eager_wall_s"],
         fcts_bitwise_unprobed=True, launches=counts, **m, card=smi)

    # ---- the card against the CPU's probed runs (made in the cpu phase)
    gpu = m4.run(dataclasses.replace(base["cpu_req"], probes=probes))
    m4_diff = series_close(np, "m4 probes card vs CPU", gpu.probes,
                           base["m4_cpu_series"], FCT_RTOL)
    cpu_fs = base["fs_cpu_series"]
    fs_equal = all(fs_series[k].tobytes() == cpu_fs[k].tobytes()
                   for k in ("t", "ev")) and all(
        v.tobytes() == cpu_fs["channels"][ch].tobytes()
        for ch, v in fs_series["channels"].items())
    if not fs_equal:
        raise AssertionError("flowsim_fast probes: card and CPU differ")
    emit("probes", path="cpu", m4_flows=base["cpu_req"].num_flows,
         m4_max_rel_diff=m4_diff, m4_rtol=FCT_RTOL,
         flowsim_fast_flows=req.num_flows, flowsim_fast_bitwise=fs_equal)

    # ---- the divergence observatory, traced, then from the cache
    suite = get_suite("smoke16").limit(8)
    flows = max(s.num_flows for s in suite)
    batched = 2 * flows            # one chunk of 8: one padded batch
    reg = get_registry()
    hit_keys = [f'sweep.cache_hits{{backend="{b}"}}' for b in ("m4",
                                                              "packet")]
    with tempfile.TemporaryDirectory() as work:
        trace_dir = os.path.join(work, "trace")
        configure(trace_dir, proc="chip_smoke")
        kw = dict(cache_dir=os.path.join(work, "cache"),
                  probes=ProbeConfig(stride=4, max_samples=64),
                  probes_dir=os.path.join(trace_dir, "probes"))
        packet = get_backend("packet")
        try:
            rep, counts, wall = run_counted(torch, lambda: obs_diff.diff_sweep(
                suite, m4, packet, **kw))
            before = [reg.snapshot()["counters"].get(k, 0) for k in hit_keys]
            again, re_counts, re_wall = run_counted(
                torch, lambda: obs_diff.diff_sweep(suite, m4, packet, **kw))
            after = [reg.snapshot()["counters"].get(k, 0) for k in hit_keys]
        finally:
            configure(None)
            os.environ.pop("REPRO_TRACE_DIR", None)
        # the first call runs m4's FCT pass and its probed pass; the
        # second only the probed pass (probes bypass the cache)
        if counts != launches(4 * batched, 2 * batched):
            raise AssertionError(f"diff_sweep: launches {counts}")
        if re_counts != launches(2 * batched, batched) or \
                [a - b for a, b in zip(after, before)] != [8, 8]:
            raise AssertionError(f"diff_sweep re-run: launches {re_counts}, "
                                 f"cache hits {before} -> {after}")
        if again["summary"] != rep["summary"]:
            raise AssertionError("diff_sweep re-run: another summary")
        for p in rep["profiles"]:
            if set(p["probe_distance"]) != {"link_active",
                                            "flow_remaining"} or not all(
                    np.isfinite(v) for v in p["probe_distance"].values()):
                raise AssertionError(f"diff_sweep: probe distance {p}")
        with contextlib.redirect_stdout(sys.stderr):
            rc = obs_main(["--check", "--dir", trace_dir])
        if rc != 0:
            raise AssertionError("python -m repro_torch.obs --check failed")
        n_probe_files = len(os.listdir(kw["probes_dir"]))
    snap = reg.snapshot()

    def entries(snapshot, prefixes):
        out = {k: v for sec in ("counters", "gauges")
               for k, v in snapshot[sec].items() if k.startswith(prefixes)}
        for k, h in snapshot["histograms"].items():
            if k.startswith(prefixes):
                out[k] = {"count": h["count"], "sum": h["sum"]}
        return out
    emit("probes", path="diff", suite="smoke16", specs=len(suite),
         flows=[s.num_flows for s in suite], backend="m4",
         oracle="packet", batched_events=batched, wall_s=wall,
         rerun_wall_s=re_wall, launches=counts, rerun_launches=re_counts,
         rerun_cache_hits=[a - b for a, b in zip(after, before)],
         summary=rep["summary"], families=rep["families"],
         probe_files=n_probe_files, obs_check_rc=rc,
         registry=entries(snap, ("sweep.", "phase.", "kernels.")),
         diff=entries(rep["obs"], ("diff.",)), card=smi)
    emit("probes", step="phase", seconds=time.perf_counter() - t_phase)
    return total


def check_update(torch, name, got, want, p0, lr):
    """Parameters after one AdamW update from p0 on two devices, by the
    rule of tests/test_torch_training.py: AdamW's first step is about
    lr * sign(g) per element, so where the gradient is well determined
    (|g| above 1e-3 of its leaf's max; g read from the first moment,
    m = 0.1 g) the updates agree at rtol 1e-3, and anywhere they differ
    by at most 2 lr."""
    from repro_torch.weights import tree_leaves
    worst = 0.0
    for (path, a), (_, b), (_, o), (_, m) in zip(
            tree_leaves(got.params), tree_leaves(want.params),
            tree_leaves(p0), tree_leaves(want.opt["m"])):
        dg, dc = a.cpu() - o.cpu(), b.cpu() - o.cpu()
        m = m.cpu().abs()
        big = m > 1e-3 * m.max()
        if not torch.allclose(dg[big], dc[big], rtol=1e-3, atol=0.0):
            raise AssertionError(f"{name}: update of {path} differs beyond "
                                 "rtol 1e-3 where its gradient is well "
                                 "determined")
        diff = float((dg - dc).abs().max())
        if diff > 2 * lr * (1 + 1e-3):
            raise AssertionError(f"{name}: update of {path} differs by "
                                 f"{diff} > 2 lr")
        worst = max(worst, diff)
    return worst


def phase_train(torch, np, cfg, dev, smi):
    """m4's training path on the card: DES -> EventBatch (build_dataset
    over scenario specs) -> fit (per sim, batch) -> checkpoints and resume
    -> evaluate_m4 over a spec. Returns the evaluation's launch counts."""
    import dataclasses
    import tempfile
    from repro_torch.core.training import combined_loss
    from repro_torch.scenarios import random_spec
    from repro_torch.train import (TrainConfig, build_dataset, evaluate_m4,
                                   fit, init_state, load_state)
    from repro_torch.weights import tree_digest, tree_leaves, tree_map

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    clock = [time.perf_counter()]

    def line(**kw):
        """One `train` line, with the wall time since the last one (the
        step and its set-up)."""
        now = time.perf_counter()
        emit("train", **kw, since_last_line_s=now - clock[0])
        clock[0] = now

    # ---- ground truth: the packet DES on two Table-2 scenarios, cut from
    # 2000 to TRAIN_FLOWS flows to keep the phase near three minutes (a
    # full-width update costs ~14-19 ms per event on the host), through
    # the dataset store
    cut_flows = f"num_flows 2000 -> {TRAIN_FLOWS}"
    specs = [random_spec(s, num_flows=TRAIN_FLOWS) for s in (0, 1)]
    with tempfile.TemporaryDirectory() as store:
        batches, report = build_dataset(specs, cfg, store, log=log)
    line(step="ground_truth", flows=[s.num_flows for s in specs],
         events=[b.num_events for b in batches],
         links=[b.num_links for b in batches], build_dataset_s=report.wall_s,
         misses=report.misses, cut=cut_flows)

    def fit_counted(name, bs, tc, **extra):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (state, hist), counts, wall = run_counted(torch, lambda: fit(
            bs, cfg, tc, state=init_state(cfg, 0, device=dev), device=dev,
            log=log))
        if counts != launches():
            raise AssertionError(f"train {name}: the differentiated step "
                                 f"launched kernels {counts}")
        h = hist[-1]
        updates = len(bs) if tc.step_mode == "per_sim" else 1
        k = max(b.num_events for b in bs)
        if not all(np.isfinite(h[x]) for x in ("loss", "grad_norm")):
            raise AssertionError(f"train {name}: loss or grad norm not "
                                 "finite")
        line(step=name, step_mode=tc.step_mode, sims=len(bs),
             events_per_sim=k, updates=state.step, wall_s=wall,
             s_per_update=h["step_s"] / updates,
             events_per_s=len(bs) * k / h["step_s"],
             peak_memory_bytes=torch.cuda.max_memory_allocated(),
             loss=h["loss"], sldn=h["sldn"], size=h["size"],
             queue=h["queue"], grad_norm=h["grad_norm"], lr=h["lr"],
             launches=counts, card=smi, **extra)
        return state, hist

    # ---- fit, per sim: one epoch over the two sims, the defaults
    state, _ = fit_counted("fit_per_sim", batches, TrainConfig(epochs=1),
                           cut=cut_flows)
    trained = state.params
    del state

    # ---- gradient coverage: one backward on the card, sim 0 cut to 200
    one = [batches[0].head(200)]
    k = one[0].num_events
    b0 = {n: torch.from_numpy(v).to(dev) for n, v in
          one[0].to_arrays().items()}
    leaves = tree_map(lambda t: t.clone().requires_grad_(),
                      init_state(cfg, 0, device=dev).params)

    def backward():
        combined_loss(leaves, cfg, b0)[0].backward()

    _, counts, wall = run_counted(torch, backward)
    dead = [p for p, l in tree_leaves(leaves)
            if l.grad is None or not bool(torch.isfinite(l.grad).all())
            or float(l.grad.abs().max()) == 0.0]
    if dead or counts != launches():
        raise AssertionError(f"gradient coverage: dead leaves {dead}, "
                             f"launches {counts}")
    line(step="gradient_coverage", events=k,
         leaves=len(list(tree_leaves(leaves))), dead_leaves=0,
         min_leaf_max_abs_grad=min(float(l.grad.abs().max())
                                   for _, l in tree_leaves(leaves)),
         wall_s=wall, launches=counts)

    # ---- where the time goes: the first 40 of those events, forward
    # alone, forward + backward, then that under the profiler (whose
    # trace takes ~0.5 s per event to read back)
    k = 40
    b0 = {n: torch.from_numpy(v).to(dev) for n, v in batches[0].head(
        k).to_arrays().items()}

    def forward():
        combined_loss(leaves, cfg, b0)

    _, _, fwd_wall = run_counted(torch, forward)
    _, _, plain_wall = run_counted(torch, backward)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, _, wall = run_counted(torch, backward)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    top = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)
    line(step="profile", events=k, wall_s=wall,
         forward_ms_per_event=1e3 * fwd_wall / k,
         unprofiled_ms_per_event=1e3 * plain_wall / k,
         cuda_kernels_per_event=len(kernels) / k,
         device_us_per_event=busy_us / k,
         device_busy_share=busy_us * 1e-6 / wall,
         device_busy_share_unprofiled=busy_us * 1e-6 / plain_wall,
         top_device_us=[(e.key, e.device_time_total) for e in top[:8]],
         card=smi)
    del leaves, b0

    # ---- batch mode: one bucket of both sims, cut to 1000 events
    cut = [b.head(1000) for b in batches]
    fit_counted("fit_batch", cut, TrainConfig(epochs=1, step_mode="batch"),
                cut=f"{cut_flows}, max_events=1000")

    # ---- the card against the CPU: one per-sim update, 200 events
    tc = TrainConfig(epochs=1, shuffle=False)
    gpu, gh = fit(one, cfg, tc, state=init_state(cfg, 0, device=dev),
                  device=dev, log=log)
    cpu, ch = fit(one, cfg, tc, state=init_state(cfg, 0, device="cpu"),
                  device="cpu", log=log)
    rel = {key: abs(gh[0][key] - ch[0][key]) / abs(ch[0][key])
           for key in ("loss", "sldn", "size", "queue", "grad_norm")}
    if max(rel.values()) > 1e-4:
        raise AssertionError(f"train card vs CPU: losses differ {rel}")
    worst = check_update(torch, "train card vs CPU", gpu, cpu,
                         init_state(cfg, 0, device="cpu").params,
                         ch[0]["lr"])
    line(step="card_vs_cpu", events=200, rel_diff=rel, rtol=1e-4,
         max_abs_update_diff=worst, lr=ch[0]["lr"],
         cpu_wall_s=ch[0]["wall_s"], card_wall_s=gh[0]["wall_s"])
    del gpu, cpu

    # ---- checkpoint and resume: 1 epoch, then 2, against 2 in one go
    # (constant LR: the warmup-cosine schedule spans the configured epochs)
    cut200 = [b.head(200) for b in batches]
    with tempfile.TemporaryDirectory() as tmp:
        tc = TrainConfig(epochs=2, schedule="const",
                         ckpt_dir=os.path.join(tmp, "resumed"))
        fit(cut200, cfg, dataclasses.replace(tc, epochs=1),
            state=init_state(cfg, 0, device=dev), device=dev, log=log)
        resumed, rh = fit(cut200, cfg, tc,
                          state=init_state(cfg, 0, device=dev), device=dev,
                          log=log)
        full, fh = fit(cut200, cfg, dataclasses.replace(tc, ckpt_dir=None),
                       state=init_state(cfg, 0, device=dev), device=dev,
                       log=log)
        restored, done = load_state(tc.ckpt_dir, cfg, device=dev)
    # tree_digest hashes every leaf's bytes: equal digests, bitwise trees
    digests = (tree_digest(resumed.tree()), tree_digest(full.tree()),
               tree_digest(restored.tree()))
    if len(set(digests)) != 1 or done != 2 or \
            [h["loss"] for h in rh] != [h["loss"] for h in fh]:
        raise AssertionError(f"train resume: not bitwise (digests "
                             f"{digests}, epochs {done})")
    line(step="resume", events=200, sims=2, epochs=2,
         schedule="const", bitwise=True, tree_digest=digests[0][:16],
         updates=resumed.step)
    del resumed, full, restored

    # ---- evaluation of the trained weights on a held-out scenario
    espec = random_spec(2)
    report, counts, wall = run_counted(torch, lambda: evaluate_m4(
        trained, cfg, [espec], device=dev))
    events = 2 * espec.num_flows
    if counts != launches(2 * events, events):
        raise AssertionError(f"evaluate_m4: launches {counts}, expected "
                             f"{launches(2 * events, events)}")
    if not (np.isfinite(report["m4_err_mean"])
            and np.isfinite(report["flowsim_err_mean"])):
        raise AssertionError(f"evaluate_m4: errors not finite {report}")
    line(step="evaluate_m4", flows=espec.num_flows, events=events,
         m4_err_mean=report["m4_err_mean"],
         flowsim_err_mean=report["flowsim_err_mean"], wall_s=wall,
         launches=counts, card=smi)
    return counts


def phase_sweep(torch, np, m4, fs, params, cfg, smi):
    """The sweep engine and the one-call pipeline on the card: smoke16
    (16 specs, four topologies and four workload families, 200-260
    flows) through SweepRunner at chunk 8 for m4 and flowsim_fast, with
    the launch counters, a cached re-run, and two specs of each chunk
    against the CPU; then `python -m repro_torch.train` in-process at
    paper width, twice (the second a finished resume). Returns the
    sweeps' launch counts."""
    import contextlib
    import tempfile
    from repro_torch.scenarios import SweepRunner, get_suite
    from repro_torch.sim import get_backend
    from repro_torch.train.__main__ import main as train_main
    from repro_torch.weights import params_to

    t_phase = time.perf_counter()
    sweep = get_suite("smoke16", num_flows=SWEEP_FLOWS)
    reqs = [spec.to_request() for spec in sweep]
    # SweepRunner -> run_chunked sorts by footprint: here by flow count,
    # so the chunks are specs 0-7 and 8-15, each padded to its largest
    chunks = [reqs[:8], reqs[8:]]
    batched = sum(2 * max(r.num_flows for r in c) for c in chunks)
    scenario_events = sum(2 * r.num_flows for r in reqs)
    total = launches()
    with tempfile.TemporaryDirectory() as cache:
        for name, backend, per_event, cpu in (
                ("m4", m4, launches(2, 1), get_backend(
                    "m4", params=params_to(params, "cpu"), cfg=cfg,
                    device="cpu")),
                ("flowsim_fast", fs, launches(event=1),
                 get_backend("flowsim_fast", device="cpu"))):
            runner = SweepRunner(backend, cache_dir=cache, chunk_size=8)
            rep, counts, wall = run_counted(torch, lambda: runner.run(sweep))
            want = {k: v * batched for k, v in per_event.items()}
            if counts != want or rep.misses != 16:
                raise AssertionError(f"sweep {name}: launches {counts}, "
                                     f"expected {want}; misses "
                                     f"{rep.misses}")
            check_fcts(np, [e.result for e in rep.entries], reqs)
            for k, v in counts.items():
                total[k] += v
            again, re_counts, re_wall = run_counted(
                torch, lambda: runner.run(sweep))
            # the cache keeps float64 (of m4's float32, exactly)
            same = all(np.asarray(a.result.fcts, np.float64).tobytes()
                       == np.asarray(b.result.fcts, np.float64).tobytes()
                       for a, b in zip(again.entries, rep.entries))
            if again.hits != 16 or not same or re_counts != launches():
                raise AssertionError(f"sweep {name} re-run: hits "
                                     f"{again.hits}, bitwise {same}, "
                                     f"launches {re_counts}")
            # one spec of each family and of each topology, two from each
            # chunk, against the CPU. m4's clock is float32 and an FCT the
            # difference of two of its readings: completion times are held
            # at rtol 1e-4, FCTs at rtol 1e-4 up to one float32 ulp of the
            # completion time (which can exceed 1e-4 of a short FCT)
            pick = [0, 5, 10, 15]
            t0 = time.perf_counter()
            ref = cpu.run_chunked([reqs[i] for i in pick], 8)
            cpu_s = time.perf_counter() - t0
            got = np.concatenate([rep.entries[i].result.fcts for i in pick])
            want_f = np.concatenate([r.fcts for r in ref])
            arr = np.concatenate([[f.t_arrival for f in reqs[i].flows]
                                  for i in pick])
            rel = np.abs(got - want_f) / np.abs(want_f)
            done_rel = np.abs(got - want_f) / np.abs(arr + want_f)
            ulp = np.spacing((arr + want_f).astype(np.float32)).astype(
                np.float64)
            if name == "flowsim_fast":
                ok = got.tobytes() == want_f.tobytes()
            else:
                ok = bool((done_rel <= FCT_RTOL).all() and (
                    np.abs(got - want_f) <= FCT_RTOL * np.abs(want_f)
                    + ulp).all())
            if not ok:
                raise AssertionError(f"sweep {name}: card and CPU differ "
                                     f"(max rel FCT {rel.max()}, max rel "
                                     f"completion time {done_rel.max()})")
            emit("sweep", path=name, suite="smoke16", specs=len(reqs),
                 flows=[r.num_flows for r in reqs], chunk_size=8, chunks=2,
                 topologies=4, workloads=4, wall_s=wall,
                 simulate_s=rep.simulate_s, batched_events=batched,
                 batched_events_per_s=batched / rep.simulate_s,
                 scenario_events_per_s=scenario_events / rep.simulate_s,
                 launches=counts, rerun_hits=again.hits,
                 rerun_bitwise=same, rerun_wall_s=re_wall,
                 rerun_launches=re_counts, cpu_specs=pick, cpu_s=cpu_s,
                 cpu_max_rel_fct_diff=float(rel.max()),
                 cpu_max_rel_completion_diff=float(done_rel.max()),
                 cpu_fcts_beyond_rtol=int((rel > FCT_RTOL).sum()),
                 cpu_bitwise_equal=bool(got.tobytes() == want_f.tobytes()),
                 rtol=0.0 if name == "flowsim_fast" else FCT_RTOL, card=smi)
            # where the time goes at B = 8: the first chunk of smoke16 at
            # its own 30-58 flows (at 200 flows the trace's read-back took
            # ~30 s), timed once unprofiled for the busy share of the same
            # requests
            small = [s.to_request() for s in get_suite("smoke16")][:8]
            t0 = time.perf_counter()
            backend.run_many(small)
            torch.cuda.synchronize()
            rate = (2 * max(r.num_flows for r in small)
                    / (time.perf_counter() - t0))
            phase_profile(torch, f"{name}_sweep_chunk", backend, small, smi,
                          rate)

    # ---- the training CLI in-process, twice; its stdout goes to stderr
    with tempfile.TemporaryDirectory() as work:
        argv = ["--workdir", work, "--hidden", "400", "--gnn-dim", "300",
                "--mlp-hidden", "200", "--snap-flows", "64",
                "--snap-links", "128", "--suite", "table2_train_space",
                "--n", "2", "--num-flows", str(CLI_FLOWS), "--epochs", "1",
                "--eval-suite", "table3_empirical", "--eval-n", "2",
                "--eval-flows", str(CLI_FLOWS)]
        cache = os.path.join(work, "sweep_cache")
        eval_events = 2 * CLI_FLOWS
        logs, entries = [], None
        for run in ("first", "resume"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with contextlib.redirect_stdout(sys.stderr):
                rc, counts, wall = run_counted(torch,
                                               lambda: train_main(argv))
            with open(os.path.join(work, "train_log.json")) as f:
                tlog = json.load(f)
            cached = sorted(os.path.relpath(os.path.join(d, n), cache)
                            for d, _, ns in os.walk(cache) for n in ns)
            want = launches(2 * eval_events, eval_events)
            if rc != 0 or counts != want:
                raise AssertionError(f"train CLI {run}: rc {rc}, launches "
                                     f"{counts}, expected {want} (m4's "
                                     "eval only)")
            ev = tlog["eval"]
            if not (np.isfinite(ev["m4_err_mean"])
                    and np.isfinite(ev["flowsim_err_mean"])):
                raise AssertionError(f"train CLI {run}: eval {ev}")
            epochs = tlog["train"]["epochs"]
            emit("sweep", path="train_cli", run=run, wall_s=wall,
                 updates=tlog["train"]["updates"],
                 step_s=tlog["train"]["step_s"],
                 s_per_update=tlog["train"]["step_s"] / max(
                     tlog["train"]["updates"], 1),
                 epochs_trained_this_run=len(epochs) if run == "first"
                 else 0, dataset_hits=tlog["dataset"]["hits"],
                 dataset_misses=tlog["dataset"]["misses"],
                 peak_memory_bytes=torch.cuda.max_memory_allocated(),
                 m4_err_mean=ev["m4_err_mean"],
                 flowsim_err_mean=ev["flowsim_err_mean"],
                 weights_hash=tlog["weights_hash"][:16],
                 sweep_cache_entries=len(cached), launches=counts,
                 flows=CLI_FLOWS, card=smi)
            logs.append(tlog)
            if entries is None:
                entries = cached
        first, again = logs
        if again["weights_hash"] != first["weights_hash"] or \
                (again["dataset"]["hits"], again["dataset"]["misses"]) != \
                (2, 0) or cached != entries or \
                again["train"]["epochs"] != first["train"]["epochs"]:
            raise AssertionError("train CLI re-run: not a finished resume "
                                 f"(hashes {first['weights_hash'][:12]} / "
                                 f"{again['weights_hash'][:12]}, dataset "
                                 f"{again['dataset']}, sweep cache "
                                 f"{len(entries)} -> {len(cached)})")
    emit("sweep", step="phase", seconds=time.perf_counter() - t_phase)
    return total


def fleet_records(out_dir):
    """The lines `CountedJob` wrote in the workers, oldest first."""
    recs = []
    if os.path.isdir(out_dir):
        for name in sorted(os.listdir(out_dir)):
            with open(os.path.join(out_dir, name)) as f:
                recs += [json.loads(ln) for ln in f if ln.strip()]
    return sorted(recs, key=lambda r: r["t_start"])


def sum_launches(recs):
    total = launches()
    for r in recs:
        for k, v in r["launches"].items():
            total[k] += v
    return total


def task_overlap_s(recs):
    """Seconds in which two or more workers were inside a task at once
    (a worker runs one task at a time, so its own windows never
    overlap)."""
    edges = sorted([(r["t_start"], 1) for r in recs]
                   + [(r["t_end"], -1) for r in recs])
    both, active, last = 0.0, 0, None
    for t, step in edges:
        if active >= 2:
            both += t - last
        active, last = active + step, t
    return both


def cache_bytes(np, cache_dir, keys):
    """FCT and slowdown bytes (float64, as cached) of every key."""
    from repro_torch.scenarios.cache import ResultCache
    store = ResultCache(cache_dir)
    out = {}
    for k in keys:
        res = store.get(k)
        if res is None:
            raise AssertionError(f"fleet: no entry {k[:12]} in {cache_dir}")
        out[k] = (np.asarray(res.fcts, np.float64).tobytes(),
                  np.asarray(res.slowdowns, np.float64).tobytes())
    return out


def worker_timings(trace_dir, recs):
    """Per worker of a traced fleet run, seconds from the start of the
    run (which spawns the whole pool at once): to the worker's entry
    (interpreter, torch and the port imported, the job unpickled), to
    its first claim, and to the end of its first task; with the seconds
    its first task spent building the backend (CUDA context, weights
    onto the card) and then running (graph captures included)."""
    from repro_torch.obs.trace import read_spans
    spans = read_spans(trace_dir)
    t0 = min(s["t_start"] for s in spans if s["name"] == "fleet.run")
    out = {}
    for s in sorted(spans, key=lambda s: s["t_start"]):
        proc = s.get("proc", "")
        if not proc.startswith("fleet-w"):
            continue
        w = out.setdefault(proc, {"pid": s["pid"], "tasks": 0})
        if s["name"] == "fleet.worker":
            w["spawn_to_entry_s"] = s["t_start"] - t0
        elif s["name"] == "fleet.claim":
            w.setdefault("spawn_to_first_claim_s", s["t_start"] - t0)
        elif s["name"] == "fleet.task":
            w["tasks"] += 1
            w.setdefault("spawn_to_first_task_end_s", s["t_end"] - t0)
    for w in out.values():
        first = [r for r in recs if r["pid"] == w["pid"] and r["first"]]
        if first:
            w["first_task_backend_s"] = first[0]["backend_s"]
            w["first_task_run_s"] = first[0]["run_s"]
    return out


def phase_fleet(torch, np, m4, fs, smi):
    """The fault-tolerant fleet on the card: smoke16 at SWEEP_FLOWS
    through SweepRunner(fleet=FleetConfig(workers=2)) at chunk
    FLEET_CHUNK, for m4 at full width and for flowsim_fast, each against
    an in-process SweepRunner at the same chunk (cache bytes bitwise,
    launches equal); flowsim_fast again under FLEET_CHAOS, converging to
    the clean run's cache; a relaunch that spawns nothing; and m4 with
    diff_against=flowsim_fast over the cache holding the oracle's
    entries, traced, then `python -m repro_torch.obs --check --coord`.
    The workers' launches come back through `CountedJob`. Returns the
    launches of the two clean fleets' workers."""
    import tempfile
    from unittest import mock
    import repro_torch.fleet as fleet_pkg
    from repro_torch.fleet import (FleetConfig, parse_plan, run_fleet,
                                   sweep_job_for, sweep_tasks)
    from repro_torch.obs import configure
    from repro_torch.obs.diff import divergence_from_coord
    from repro_torch.scenarios import SweepRunner, get_suite
    from repro_torch.scenarios.cache import result_key

    t_phase = time.perf_counter()
    sweep = get_suite("smoke16", num_flows=SWEEP_FLOWS)
    specs = list(sweep)
    reqs = [spec.to_request() for spec in specs]
    # sweep_tasks sorts by footprint, as run_chunked does
    order = sorted(reqs, key=lambda r: (r.num_flows, r.topo.num_links))
    chunks = [order[i:i + FLEET_CHUNK]
              for i in range(0, len(order), FLEET_CHUNK)]
    batched = sum(2 * max(r.num_flows for r in c) for c in chunks)
    real_job_for = fleet_pkg.sweep_job_for
    total = launches()
    with tempfile.TemporaryDirectory() as work:
        def path(*parts):
            return os.path.join(work, *parts)

        def config(tag, **kw):
            return FleetConfig(workers=2, coord_dir=path("coord", tag),
                               chunk_timeout_s=300.0, **kw)

        def fleet_run(runner, tag):
            """runner.run(sweep) with its fleet's jobs wrapped in
            CountedJob; the tracer the fleet configured is undone."""
            wrap = mock.patch.object(
                fleet_pkg, "sweep_job_for", lambda *a, **kw: CountedJob(
                    real_job_for(*a, **kw), path("counts", tag)))
            try:
                with wrap:
                    t0 = time.perf_counter()
                    rep = runner.run(sweep)
                    wall = time.perf_counter() - t0
            finally:
                configure(None)
                os.environ.pop("REPRO_TRACE_DIR", None)
            recs = fleet_records(path("counts", tag))
            jax_mods = sorted({m for r in recs for m in r["jax_modules"]})
            m = rep.fleet
            if m is None or not (m["done"] == m["accounted"] == m["total"]
                                 == len(chunks)) or m["poisoned"] or \
                    m["workers_spawned"] < 2 or rep.misses != len(specs) \
                    or jax_mods:
                raise AssertionError(f"fleet {tag}: metrics {m}, misses "
                                     f"{rep.misses}, worker imports "
                                     f"{jax_mods}")
            return rep, wall, recs

        keys = {}
        for name, backend, per_event in (
                ("m4", m4, launches(2, 1)),
                ("flowsim_fast", fs, launches(event=1))):
            keys[name] = [result_key(r, backend) for r in reqs]
            inline = SweepRunner(backend, cache_dir=path("inline", name),
                                 chunk_size=FLEET_CHUNK)
            ref, ref_counts, ref_wall = run_counted(
                torch, lambda: inline.run(sweep))
            trace = path("trace", name)
            runner = SweepRunner(backend, cache_dir=path("fleet", name),
                                 chunk_size=FLEET_CHUNK,
                                 fleet=config(name, trace_dir=trace))
            rep, wall, recs = fleet_run(runner, name)
            counts = sum_launches(recs)
            want = {k: v * batched for k, v in per_event.items()}
            same = cache_bytes(np, path("fleet", name), keys[name]) == \
                cache_bytes(np, path("inline", name), keys[name])
            same_entries = all(
                np.asarray(a.result.fcts, np.float64).tobytes()
                == np.asarray(b.result.fcts, np.float64).tobytes()
                and np.asarray(a.result.slowdowns, np.float64).tobytes()
                == np.asarray(b.result.slowdowns, np.float64).tobytes()
                for a, b in zip(rep.entries, ref.entries))
            fp = backend.fingerprint()
            # m4: two processes, each with its own CUDA context and its
            # own copy of the GNN's grid-barrier count, launch on the card
            # at once; their results are the in-process ones bitwise
            overlap = task_overlap_s(recs)
            if not (same and same_entries) or not fp.endswith("-kcuda") \
                    or not counts == ref_counts == want or \
                    (name == "m4" and overlap <= 0.0):
                raise AssertionError(
                    f"fleet {name}: bitwise {same}/{same_entries}, "
                    f"fingerprint {fp}, launches {counts} (in-process "
                    f"{ref_counts}, expected {want}), workers' tasks "
                    f"overlapped {overlap} s")
            for k, v in counts.items():
                total[k] += v
            emit("fleet", path=name, suite="smoke16", specs=len(specs),
                 chunk_size=FLEET_CHUNK, tasks=len(chunks), workers=2,
                 wall_s=wall, simulate_s=rep.simulate_s,
                 inprocess_wall_s=ref_wall,
                 inprocess_simulate_s=ref.simulate_s, batched_events=batched,
                 metrics=rep.fleet, worker_timings=worker_timings(trace, recs),
                 task_records=[{k: r[k] for k in ("pid", "first", "backend_s",
                                                  "run_s")} for r in recs],
                 task_overlap_s=overlap, launches=counts,
                 inprocess_launches=ref_counts, bitwise_inprocess=True,
                 fingerprint=fp, card=smi)

        # ---- chaos: flowsim_fast under the fault plan, into a fresh cache
        chaos_cfg = config("chaos", chaos=parse_plan(FLEET_CHAOS))
        runner = SweepRunner(fs, cache_dir=path("chaos"),
                             chunk_size=FLEET_CHUNK, fleet=chaos_cfg)
        rep, wall, recs = fleet_run(runner, "chaos")
        m = rep.fleet
        same = cache_bytes(np, path("chaos"), keys["flowsim_fast"]) == \
            cache_bytes(np, path("fleet", "flowsim_fast"),
                        keys["flowsim_fast"])
        quarantined = sum(n.endswith(".corrupt")
                          for _, _, ns in os.walk(path("chaos")) for n in ns)
        if not same or m["worker_restarts"] < 1 or m["retried"] < 1 or \
                quarantined != 1:
            raise AssertionError(f"fleet chaos: bitwise {same}, metrics "
                                 f"{m}, quarantined {quarantined}")
        emit("fleet", path="chaos", plan=FLEET_CHAOS, wall_s=wall,
             metrics=m, launches=sum_launches(recs), bitwise_clean=True,
             quarantined=quarantined, card=smi)

        # ---- relaunch: the same fleet over the same cache and
        # coordination directory, then the same runner
        tasks = sweep_tasks(specs, reqs, keys["flowsim_fast"], FLEET_CHUNK)
        t0 = time.perf_counter()
        again = run_fleet(tasks, sweep_job_for(fs, path("chaos")), chaos_cfg)
        relaunch_wall = time.perf_counter() - t0
        rerun, re_counts, re_wall = run_counted(torch,
                                                lambda: runner.run(sweep))
        if again.workers_spawned != 0 or again.computed != 0 or \
                again.already_done != len(chunks) or \
                rerun.hits != len(specs) or rerun.fleet is not None or \
                re_counts != launches():
            raise AssertionError(f"fleet relaunch: {again.as_dict()}, "
                                 f"hits {rerun.hits}, launches {re_counts}")
        emit("fleet", path="relaunch", wall_s=relaunch_wall,
             metrics=again.as_dict(), runner_wall_s=re_wall,
             runner_hits=rerun.hits, launches=re_counts, card=smi)

        # ---- diff_against: m4 over the cache of flowsim_fast's entries
        trace = path("trace", "diff")
        runner = SweepRunner(m4, cache_dir=path("fleet", "flowsim_fast"),
                             chunk_size=FLEET_CHUNK, diff_against=fs,
                             fleet=config("diff", trace_dir=trace))
        rep, wall, recs = fleet_run(runner, "diff")
        div = divergence_from_coord(path("coord", "diff"))
        same = cache_bytes(np, path("fleet", "flowsim_fast"), keys["m4"]) \
            == cache_bytes(np, path("fleet", "m4"), keys["m4"])
        check = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs", "--dir", trace,
             "--check", "--coord", path("coord", "diff")],
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
            capture_output=True, text=True, timeout=300)
        if div["tasks"] != len(chunks) or \
                set(div["scenarios"]) != {s.label for s in specs} or \
                not all(np.isfinite(v) for v in div["scenarios"].values()) \
                or not same or check.returncode != 0:
            raise AssertionError(f"fleet diff_against: divergence {div}, "
                                 f"bitwise {same}, obs check rc "
                                 f"{check.returncode}: {check.stdout}")
        emit("fleet", path="diff_against", oracle=fs.fingerprint(),
             wall_s=wall, metrics=rep.fleet, divergence=div,
             worker_timings=worker_timings(trace, recs),
             task_overlap_s=task_overlap_s(recs),
             launches=sum_launches(recs), bitwise_clean_m4=True,
             obs_check=check.stdout.strip().splitlines()[-1], card=smi)
    emit("fleet", step="phase", seconds=time.perf_counter() - t_phase)
    return total


def serve_specs(n_unique, flows):
    """`n_unique` Table-2 specs (`random_spec`, the scenarios of
    `sample_scenario`) on the 8-rack fat tree at 4-to-1 (80 links), at
    each flow count of `flows`: one shape bucket per flow count."""
    from repro_torch.scenarios.spec import random_spec
    seeds = [s for s in range(256)
             if random_spec(s, num_flows=1).oversub == "4-to-1"]
    return [random_spec(s, num_flows=n) for n in flows
            for s in seeds[:n_unique]]


def record_batches(backend):
    """Note every batch the service hands `backend.run_many`, with its
    results; returns the list and the unwrapped `run_many`."""
    plain, batches = backend.run_many, []

    def run_many(requests):
        out = plain(requests)
        batches.append((list(requests), out))
        return out
    backend.run_many = run_many
    return batches, plain


def check_batches(np, name, batches, plain):
    """Every recorded batch again through `run_many`: bitwise. Returns a
    map content hash -> FCTs."""
    fcts = {}
    for reqs, out in batches:
        for r, a, b in zip(reqs, out, plain(reqs)):
            if np.asarray(a.fcts).tobytes() != np.asarray(b.fcts).tobytes():
                raise AssertionError(f"serve {name}: a result differs from "
                                     "run_many of its padded batch")
            fcts[r.content_hash()] = np.asarray(a.fcts, np.float64)
    return fcts


def phase_serve(torch, np, params, cfg, smi):
    """The simulation service at full width: lanes m4 (`init_m4(0)`,
    `M4Config()`, batch 8) and flowsim_fast (batch 4) behind the HTTP
    front-end on an ephemeral port; 4 client threads post SERVE_UNIQUE
    specs in each of the buckets of SERVE_FLOWS to both lanes, each
    client with all its requests in flight at once, then all again
    (every one a cache hit); a drained close; then a second service
    with no cache takes the same m4 requests and replays the process's
    captured programs. Returns the first round's launch counts."""
    import dataclasses
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core import compiled
    from repro_torch.obs import get_registry
    from repro_torch.obs.export import lookup, parse_prometheus
    from repro_torch.scenarios.spec import spec_to_dict
    from repro_torch.serve import (ServeClient, ServeConfig, SimService,
                                   start_http_server)
    from repro_torch.sim import get_backend

    t_phase = time.perf_counter()
    specs = serve_specs(SERVE_UNIQUE, SERVE_FLOWS)
    reqs = [sp.to_request() for sp in specs]
    hashes = [r.content_hash() for r in reqs]
    m4 = get_backend("m4", params=params, cfg=cfg)
    fs = get_backend("flowsim_fast")
    lanes = {"m4": (m4, 8), "flowsim_fast": (fs, 4)}
    spies = {name: record_batches(b) for name, (b, _) in lanes.items()}
    compiled.clear_compiled()
    reg = get_registry()

    def violations():
        return reg.snapshot()["counters"].get(
            "guards.no_retrace.violations", 0)
    v0 = violations()
    jobs = [(lane, i) for lane in lanes for i in range(len(specs))]
    with tempfile.TemporaryDirectory() as cache:
        # buckets flush when full (the deadline never comes in a round)
        service = SimService(
            {name: b for name, (b, _) in lanes.items()}, cache_dir=cache,
            config={name: ServeConfig(batch_size=bs, flush_interval_s=30.0)
                    for name, (_, bs) in lanes.items()})
        server = start_http_server(service, port=0)
        client = ServeClient(f"http://127.0.0.1:{server.server_address[1]}",
                             timeout_s=600)
        rounds = []
        try:
            for rnd in ("first", "cached"):
                replies, lat, errors = {}, [], []

                def post(lane, i):
                    t0 = time.perf_counter()
                    try:
                        replies[(lane, i)] = client.simulate(
                            spec_to_dict(specs[i]), backend=lane)
                    except Exception as exc:
                        errors.append(f"{lane} {i}: {exc}")
                    lat.append(time.perf_counter() - t0)

                def drive(part):
                    # a client keeps all its requests in flight at once
                    # (one connection each), so that buckets fill
                    with ThreadPoolExecutor(len(part)) as pool:
                        list(pool.map(lambda job: post(*job), part))
                c0 = {n: sum(trace_counts(n).values()) for n in lanes}
                threads = [threading.Thread(target=drive,
                                            args=(jobs[k::4],))
                           for k in range(4)]

                def go():
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join(900)
                _, counts, wall = run_counted(torch, go)
                if errors or len(replies) != len(jobs):
                    raise AssertionError(f"serve {rnd}: {errors[:4]}")
                caps = {n: sum(trace_counts(n).values()) - c0[n]
                        for n in lanes}
                rounds.append((rnd, replies, lat, counts, wall, caps,
                               service.metrics()))
            health = client.health()
            prom = parse_prometheus(client.metrics_prometheus())
            # a drained close resolves what is still queued: a part of a
            # bucket, below its batch size, that only the drain flushes
            extra = [dataclasses.replace(specs[0], seed=1000 + k)
                     for k in range(3)]
            futs = [service.submit(sp.to_request(), backend="flowsim_fast")
                    for sp in extra]
            if any(f.done() for f in futs):
                raise AssertionError("serve: a part bucket flushed early")
        finally:
            server.shutdown()
            server.server_close()
            service.close(drain=True, timeout=600)
        if not all(f.done() and f.exception(timeout=0) is None
                   for f in futs):
            raise AssertionError("serve: close(drain=True) left a future")

    fcts = {n: check_batches(np, n, spies[n][0], spies[n][1])
            for n in lanes}
    (_, first, lat1, counts1, wall1, caps1, m1), \
        (_, cached, lat2, counts2, wall2, caps2, m2) = rounds
    for (lane, i), reply in first.items():
        if np.asarray(reply["fcts"], np.float64).tobytes() != \
                fcts[lane][hashes[i]].tobytes():
            raise AssertionError(f"serve {lane}: a reply differs from its "
                                 "batch's result")
        if cached[(lane, i)]["fcts"] != reply["fcts"]:
            raise AssertionError(f"serve {lane}: the cached reply differs")
    buckets = len(SERVE_FLOWS)
    events = sum(2 * n for n in SERVE_FLOWS)
    want = launches(2 * events, events, event=2 * events)
    if counts1 != want or caps1 != {n: buckets for n in lanes}:
        raise AssertionError(f"serve first round: launches {counts1} "
                             f"(expected {want}), captures {caps1}")
    if counts2 != launches() or caps2 != {n: 0 for n in lanes} or \
            m2["cache_hits"] != len(jobs):
        raise AssertionError(f"serve cached round: launches {counts2}, "
                             f"captures {caps2}, hits {m2['cache_hits']}")
    if violations() != v0 or m2["failed"] or m2["isolated_retries"]:
        raise AssertionError("serve: a retrace budget broke or a batch "
                             "was isolated")
    if not health["ok"] or lookup(prom, "repro_serve_completed_total") \
            != m2["completed"]:
        raise AssertionError(f"serve: /healthz {health} or /metrics")

    # a second service, no cache: the same m4 requests replay the
    # process's captured programs
    m4b = get_backend("m4", params=params, cfg=cfg)
    batches_b, plain_b = record_batches(m4b)
    c0 = sum(trace_counts("m4").values())
    with SimService(m4b, config=ServeConfig(batch_size=8,
                                            flush_interval_s=30.0)) as svc:
        res2, counts3, wall3 = run_counted(torch, lambda: [
            f.result(timeout=600)
            for f in [svc.submit(r) for r in reqs]])
    caps3 = sum(trace_counts("m4").values()) - c0
    check_batches(np, "m4 (second service)", batches_b, plain_b)
    same_as_first = all(np.asarray(r.fcts, np.float64).tobytes()
                        == fcts["m4"][h].tobytes()
                        for r, h in zip(res2, hashes))
    if caps3 != 0 or counts3 != launches(2 * events, events):
        raise AssertionError(f"serve second service: captures {caps3}, "
                             f"launches {counts3}")

    def pct(xs, q):
        return float(np.percentile(np.asarray(xs) * 1e3, q))
    for rnd, lat, wall, m in (("first", lat1, wall1, m1),
                              ("cached", lat2, wall2, m2)):
        emit("serve", round=rnd, requests=len(jobs),
             requests_per_s=len(jobs) / wall, wall_s=wall,
             latency_p50_ms=pct(lat, 50), latency_p99_ms=pct(lat, 99),
             queue_delay_p50_ms={n: m["lanes"][n]["queue_delay_p50_ms"]
                                 for n in lanes},
             queue_delay_p99_ms={n: m["lanes"][n]["queue_delay_p99_ms"]
                                 for n in lanes},
             cache_hits=m["cache_hits"], batches=m["batches"],
             compiles=m["compiles"],
             launches=counts1 if rnd == "first" else counts2,
             captures=caps1 if rnd == "first" else caps2, card=smi)
    emit("serve", step="checks", lanes={n: bs for n, (_, bs) in
                                        lanes.items()},
         flows=list(SERVE_FLOWS), unique_per_bucket=SERVE_UNIQUE,
         results_bitwise_run_many=True, captures_per_bucket=1,
         no_retrace_violations=violations() - v0,
         entries=compiled.entries(), drained=len(futs),
         second_service_captures=caps3, second_service_wall_s=wall3,
         second_service_launches=counts3,
         second_service_same_as_first=same_as_first, healthz=health,
         card=smi)
    emit("serve", step="phase", seconds=time.perf_counter() - t_phase)
    return counts1


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import dataclasses
    from repro_torch.core.model import M4Config, init_m4
    from repro_torch.core.probes import ProbeConfig
    from repro_torch.data.traffic import sample_scenario
    from repro_torch.kernels import build
    from repro_torch.sim import SimRequest, get_backend
    from repro_torch.weights import params_to

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    t_script = time.perf_counter()
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
    entries["waterfill_event"] = phase_event(torch, np, dev, fs_req)

    # ---- the main paths at full size; warm-ups (cuBLAS handles,
    # allocator pools) are not counted
    m4 = get_backend("m4", params=params, cfg=cfg)
    m4.run(req_of(7, num_flows=20))
    m4_req = req_of(0)
    m4_res, run_launches, m4_rate = phase_full(
        torch, np, "m4", m4, m4_req, [req_of(s) for s in range(4)],
        launches(2, 1), smi)
    fs = get_backend("flowsim_fast")
    fs.run(req_of(7, num_flows=20))
    fs_res, fs_launches, fs_rate = phase_full(
        torch, np, "flowsim_fast", fs, fs_req, [req_of(s) for s in range(4)],
        launches(event=1), smi)
    for k in ("masked_rowmin", "waterfill_event"):
        run_launches[k] = fs_launches[k]

    # ---- where the time goes: a short run of m4 (its event step has the
    # same shapes at any flow count) and flowsim_fast's 2000-flow `run`
    # (its kernel's time grows with the active flows and the rounds)
    phase_profile(torch, "m4", m4, req_of(3, num_flows=100), smi)
    phase_profile(torch, "flowsim_fast", fs, fs_req, smi, fs_rate)

    # ---- the card against the CPU; the CPU's runs also record probes,
    # which the probes phase holds the card's probed runs against
    probes = ProbeConfig(stride=PROBE_STRIDE, max_samples=PROBE_SAMPLES)
    creq = req_of(5, num_flows=200)
    gpu = m4.run(creq)
    cpu = get_backend("m4", params=params_to(params, "cpu"), cfg=cfg,
                      device="cpu").run(dataclasses.replace(creq,
                                                            probes=probes))
    compare_fcts(np, "m4", gpu.fcts, cpu.fcts, creq.num_flows)
    fs_cpu_series = phase_cpu_flowsim_fast(torch, np, fs_req, fs_res, dev,
                                           probes)

    phase_closed_loop(torch, np, m4, fs, cfg, smi)

    probes_launches = phase_probes(torch, np, m4, fs, {
        "m4_req": m4_req, "m4_res": m4_res, "m4_rate": m4_rate,
        "m4_many": [req_of(s, num_flows=n) for s, n in
                    ((1, 200), (2, 300), (3, 400), (4, 500))],
        "fs_req": fs_req, "fs_res": fs_res, "fs_rate": fs_rate,
        "cpu_req": creq, "m4_cpu_series": cpu.probes,
        "fs_cpu_series": fs_cpu_series}, smi)

    t0 = time.perf_counter()
    eval_launches = phase_train(torch, np, cfg, dev, smi)
    emit("train", step="phase", seconds=time.perf_counter() - t0)

    sweep_launches = phase_sweep(torch, np, m4, fs, params, cfg, smi)
    fleet_launches = phase_fleet(torch, np, m4, fs, smi)
    serve_launches = phase_serve(torch, np, params, cfg, smi)

    sources = {"fused_gru_pair": ("src/repro_torch/kernels/csrc/fused_gru.cu",
                                  "src/repro/kernels/fused_gru/kernel.py:21"),
               "bipartite_round": ("src/repro_torch/kernels/csrc/bipartite.cu",
                                   "src/repro/kernels/bipartite/kernel.py:27"),
               "masked_rowmin": ("src/repro_torch/kernels/csrc/waterfill.cu",
                                 "src/repro/kernels/waterfill/kernel.py:21"),
               "waterfill_event": ("src/repro_torch/kernels/csrc/waterfill.cu",
                                   "src/repro/kernels/waterfill/kernel.py:21")}
    line = []
    for name, e in entries.items():
        src, replaces = sources[name]
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": run_launches[name],
                     "probes_launches": probes_launches[name],
                     "train_eval_launches": eval_launches[name],
                     "sweep_launches": sweep_launches[name],
                     "fleet_launches": fleet_launches[name],
                     "serve_launches": serve_launches[name], **e})
    emit("total", seconds=time.perf_counter() - t_script)
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
