#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of m4 on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. card     — name and power limit (nvidia-smi);
2. build    — nvcc builds the kernels from src/repro_torch/kernels/csrc;
3. kernels  — each kernel against its plain PyTorch version on the card at
              the main path's shapes (both GRU stages; the GNN round at
              B = 1 and B = 4): errors, device times (CUDA-graph replay,
              so host overhead is excluded), bound, library call;
4. full     — the main path at the paper's full width (M4Config defaults,
              seeded random weights): `run` of one 2000-flow Table-2
              scenario, then `run_many` of four, through
              repro_torch.sim.get_backend("m4"); every flow done, FCTs
              finite and positive, and the launch counters show both
              kernels on the path (2 GRU-pair launches and gnn_layers
              round launches per event);
5. profile  — one short full-width run under torch.profiler: device busy
              share and CUDA kernels launched per event;
6. cpu      — the same weights on the card and on the CPU for a 200-flow
              scenario, FCTs compared at rtol 1e-4.

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

    # ---- bipartite round, B = 1 and B = 4
    layer = params["gnn"][0]
    E = SF * P
    edge_f = torch.arange(SF, device=dev).repeat_interleave(P)
    for B in (1, 4):
        f = torch.relu(randn(B, SF, G))
        l = torch.relu(randn(B, SL, G))
        edge_l = torch.randint(0, SL, (B, E), generator=g, device=dev)
        edge_mask = (torch.rand(B, E, generator=g, device=dev) < 0.7).float()
        args = (f, l, edge_f, edge_l, edge_mask, layer["wf"]["w"],
                layer["wl"]["w"], layer["wf"]["b"], layer["wl"]["b"])
        got = bip_ops.bipartite_round(*args)
        want = bip_ref.bipartite_round_ref(*args)
        m = bip_ref.incidence_from_edges(edge_f, edge_l, edge_mask, SF, SL)
        want_mm = bip_ref.bipartite_rounds_matmul([layer], f, l, m)
        errs = []
        for name, a, b, c in zip(("flow", "link"), got, want, want_mm):
            check_close(torch, f"bipartite B={B} {name}", a, b, GNN_TOL)
            check_close(torch, f"bipartite matmul form B={B} {name}", c, b,
                        GNN_TOL)
            errs.append(max_err(torch, a, b))
        # aggregation: the kernel sums the live (mask 1) edges only
        live = int(edge_mask.sum().item())
        flops = B * 2 * (SF + SL) * 2 * G * G + 2 * 2 * live * G
        nbytes = (4 * B * 2 * (SF + SL) * G + 4 * 2 * (2 * G * G + G)
                  + B * E * (8 + 8 + 4))
        b_ms, b_by = bound_ms(flops, nbytes)
        row = dict(
            shapes={"f": [B, SF, G], "l": [B, SL, G], "E": E},
            max_abs_err=max(e[0] for e in errs),
            max_rel_err=max(e[1] for e in errs),
            ms=device_ms(torch, lambda: bip_ops.bipartite_round(*args)),
            plain_ms=device_ms(torch, lambda: bip_ref.bipartite_round_ref(
                *args)),
            plain_matmul_ms=device_ms(
                torch, lambda: bip_ref.bipartite_rounds_matmul(
                    [layer], f, l, bip_ref.incidence_from_edges(
                        edge_f, edge_l, edge_mask, SF, SL))),
            library_ms=None, bound_ms=b_ms, bound_by=b_by)
        emit("kernel", name=f"bipartite_round/B{B}", **row)
        if B == 1:
            entries["bipartite_round"] = dict(
                per="launch: one round, B=1",
                max_abs_err=row["max_abs_err"], ms=row["ms"],
                plain_ms=row["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                library_ms=None,
                library="none: no single PyTorch call computes the round")
    return entries


def run_counted(torch, fn):
    """Drive fn with every launch counter at 0; return its result, the
    counts it made and its wall time (synchronised)."""
    from repro_torch.kernels.bipartite.ops import bipartite_round
    from repro_torch.kernels.fused_gru.ops import gru_pair
    torch.cuda.synchronize()
    gru_pair.launches = bipartite_round.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, {"fused_gru_pair": gru_pair.launches,
                 "bipartite_round": bipartite_round.launches}, wall


def check_fcts(np, results, reqs):
    for res, req in zip(results, reqs):
        f = np.asarray(res.fcts)
        if f.shape != (req.num_flows,):
            raise AssertionError(f"fcts of shape {f.shape}")
        if not (np.isfinite(f).all() and (f > 0).all()):
            raise AssertionError("a flow is not done, or its FCT is not "
                                 "finite and positive")


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

    dev = torch.device("cuda")
    cfg = M4Config()
    params = init_m4(0, cfg, device=dev)
    entries = phase_kernels(torch, params, cfg, dev)

    backend = get_backend("m4", params=params, cfg=cfg)
    # warm-up: cuBLAS handles, allocator pools (not counted)
    backend.run(SimRequest.from_scenario(sample_scenario(7, num_flows=20)))

    req = SimRequest.from_scenario(sample_scenario(0))
    (res,), counts, wall = run_counted(torch, lambda: [backend.run(req)])
    check_fcts(np, [res], [req])
    events = 2 * req.num_flows
    want = {"fused_gru_pair": 2 * events,
            "bipartite_round": cfg.gnn_layers * events}
    if counts != want:
        raise AssertionError(f"run: launches {counts}, expected {want}")
    emit("full", entry="run", flows=req.num_flows, events=events,
         wall_s=wall, events_per_s=events / wall, launches=counts,
         card=smi)
    run_launches = counts

    reqs = [SimRequest.from_scenario(sample_scenario(s)) for s in range(4)]
    results, counts, wall = run_counted(torch, lambda: backend.run_many(reqs))
    check_fcts(np, results, reqs)
    events = 2 * max(r.num_flows for r in reqs)
    want = {"fused_gru_pair": 2 * events,
            "bipartite_round": cfg.gnn_layers * events}
    if counts != want:
        raise AssertionError(f"run_many: launches {counts}, expected {want}")
    emit("full", entry="run_many", scenarios=len(reqs), events=events,
         wall_s=wall, events_per_s=events / wall,
         scenario_events_per_s=len(reqs) * events / wall, launches=counts,
         card=smi)

    # ---- where the time goes: one short run under the profiler
    preq = SimRequest.from_scenario(sample_scenario(3, num_flows=100))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        backend.run(preq)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    events = 2 * preq.num_flows
    top = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)[:8]
    emit("profile", flows=preq.num_flows, events=events, wall_s=wall,
         cuda_kernels_per_event=len(kernels) / events if kernels else None,
         device_busy_share=(busy_us * 1e-6 / wall) if kernels else None,
         top_device_us=[(e.key, e.device_time_total) for e in top],
         card=smi)

    # ---- the same weights on the card and on the CPU
    creq = SimRequest.from_scenario(sample_scenario(5, num_flows=200))
    gpu = backend.run(creq)
    cpu = get_backend("m4", params=params_to(params, "cpu"), cfg=cfg,
                      device="cpu").run(creq)
    rel = np.abs(gpu.fcts - cpu.fcts) / np.abs(cpu.fcts)
    emit("cpu", flows=creq.num_flows, max_rel_fct_diff=float(rel.max()),
         rtol=FCT_RTOL)
    if not np.allclose(gpu.fcts, cpu.fcts, rtol=FCT_RTOL, atol=0.0):
        first = int(np.argmax(rel > FCT_RTOL))
        raise AssertionError(f"card and CPU FCTs differ beyond rtol "
                             f"{FCT_RTOL}: flow {first}, rel {rel[first]}")

    sources = {"fused_gru_pair": ("src/repro_torch/kernels/csrc/fused_gru.cu",
                                  "src/repro/kernels/fused_gru/kernel.py:21"),
               "bipartite_round": ("src/repro_torch/kernels/csrc/bipartite.cu",
                                   "src/repro/kernels/bipartite/kernel.py:27")}
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
