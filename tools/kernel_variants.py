#!/usr/bin/env python3
"""Time variants of the port's hand-written kernels on the card.

    python tools/kernel_variants.py [--only NAME ...]

Each variant is a copy of `src/repro_torch/kernels/csrc` with a few
source lines replaced (the GRU's depth split, the GNN's tile width or slab
depth, the TF32 rounding instruction, the water-filling's threads per
block, lanes per link or list entries per step, or a diagnostic that
drops the mma, a phase, two of the three TF32 terms, all water-filling
rounds but the first, the float64 link sums, or the loads of the link
sums or of the row-min).
All variants build in parallel, one `nvcc` per source they change, into
`kernels/_build/variants/`; then each is loaded in place of the built
library and run through the wrappers: `fused_gru.ops.gru_pair` and
`bipartite.ops.bipartite_rounds` at m4's full width (`M4Config()`,
`init_m4(0)` weights), `waterfill.ops.waterfill_event` at 2000 flows
(random incidence at 96 links, B = 1 and B = 4, and the real state with
the most rounds over the first 1000 events of flowsim_fast's `run` of
`sample_scenario(1)`). Each is held against its plain version (the error
is reported, not enforced: the diagnostics are wrong by design) and timed
as `chip_smoke.py` times kernels (CUDA-graph replay). One JSON line per
variant and shape, and the card's nvidia-smi line. Needs an NVIDIA GPU
and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

GRU, GNN, HDR = "fused_gru.cu", "bipartite.cu", "tf32x3.cuh"
WF = "waterfill.cu"
WF_THREADS = "constexpr int EVENT_THREADS = 1024;"
WF_LANES = "constexpr int LINK_LANES = 8;"
WF_UNROLL = "constexpr int UNROLL = 4;"
WF_EXIT = "if (left == 0 || rounds == p.max_rounds) break;"
ROWMIN_LOOP = ("        m = INF;\n"
               "        for (int k = 0; k < K; ++k) {")
WF_ALL_ROUNDS = "if (rounds == p.max_rounds) break;"
RNA_INT = "  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;"
PRODUCT = ("    product(p, p.layer[r], cur_f, cur_l, last ? p.fo : "
           "p.tmp_f[r & 1],\n            last ? p.lo : p.tmp_l[r & 1], "
           "smem);\n")
VARIANTS = {
    "base": [],
    "gru_ks2": [(GRU, "constexpr int KS = 3;", "constexpr int KS = 2;")],
    "gru_ks4": [(GRU, "constexpr int KS = 3;", "constexpr int KS = 4;")],
    "gnn_bn32": [(GNN, "constexpr int BN = 16;", "constexpr int BN = 32;")],
    "gnn_kp96": [(GNN, "constexpr int KP = 160;", "constexpr int KP = 96;")],
    # TF32 rounding by the cvt instruction: the same bits as the base
    "split_cvt": [(HDR, RNA_INT, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;"'
                   ' : "=r"(r) : "f"(v));\n  return r;')],
    # diagnostics: wrong results by design
    "one_term": [(HDR, "  mma(small, a.lo, b.hi);\n  mma(small, a.hi, b.lo);\n",
                  "")],
    "gru_no_mma": [(GRU, "    for (int ks = 0; ks < KC / 8; ++ks) {",
                    "    for (int ks = 0; ks < 0; ++ks) {")],
    "gnn_no_product": [(GNN, PRODUCT, "")],
    "gnn_lists_barriers": [(GNN, PRODUCT, ""),
                           (GNN, "    aggregate(p, cur_f, cur_l, smem);\n",
                            "")],
    "event_threads512": [(WF, WF_THREADS,
                          "constexpr int EVENT_THREADS = 512;")],
    "event_threads256": [(WF, WF_THREADS,
                          "constexpr int EVENT_THREADS = 256;")],
    "event_lanes16": [(WF, WF_LANES, "constexpr int LINK_LANES = 16;")],
    "event_lanes32": [(WF, WF_LANES, "constexpr int LINK_LANES = 32;")],
    "event_unroll1": [(WF, WF_UNROLL, "constexpr int UNROLL = 1;")],
    # diagnostic: thread 0's clock64 cycles per phase, summed over the
    # rounds, written into rates[b, :6] (link sums, their barrier, the
    # row-min, theta's reduction, the freeze, its barrier)
    "event_clocks": [
        (WF, "  int rounds = 0, left;\n",
         "  int rounds = 0, left;\n  long long ck[6] = {}, t = clock64();\n"),
        (WF, "    __syncthreads();\n    // (c) per unfrozen flow",
         "    ck[0] += clock64() - t; t = clock64();\n    __syncthreads();\n"
         "    ck[1] += clock64() - t; t = clock64();\n"
         "    // (c) per unfrozen flow"),
        (WF, "    block_reduce(theta, left, min_slots, count_slots);\n",
         "    ck[2] += clock64() - t; t = clock64();\n"
         "    block_reduce(theta, left, min_slots, count_slots);\n"
         "    ck[3] += clock64() - t; t = clock64();\n"),
        (WF, "    __syncthreads();\n  }\n",
         "    ck[4] += clock64() - t; t = clock64();\n    __syncthreads();\n"
         "    ck[5] += clock64() - t; t = clock64();\n  }\n"),
        (WF, "  if (tid == 0) {\n    p.rounds[b] = rounds;",
         "  __syncthreads();\n  if (tid == 0) {\n"
         "    for (int q = 0; q < 6; ++q) out[q] = (float)ck[q];\n"
         "    p.rounds[b] = rounds;")],
    "event_unroll2": [(WF, WF_UNROLL, "constexpr int UNROLL = 2;")],
    "event_unroll8": [(WF, WF_UNROLL, "constexpr int UNROLL = 8;")],
    # diagnostics: launch, staging and one round; float32 link sums;
    # all 32 rounds without the link sums' or the row-min's loads
    "event_one_round": [(WF, WF_EXIT, "if (left == 0 || rounds == 1) break;")],
    "event_f32_sums": [(WF, "      double used = 0.0;",
                        "      float used = 0.0f;"),
                       (WF, "else used += (double)v[u];",
                        "else used += v[u];")],
    "event_no_link_sums": [(WF, WF_EXIT, WF_ALL_ROUNDS),
                           (WF, "for (int j = link_ptr[l] + sub; j < end;",
                            "for (int j = end; j < end;")],
    "event_no_rowmin": [(WF, WF_EXIT, WF_ALL_ROUNDS),
                        (WF, ROWMIN_LOOP,
                         ROWMIN_LOOP.replace("k < K", "k < 0"))],
}
STEMS = {GRU: ("fused_gru",), GNN: ("bipartite",),
         HDR: ("fused_gru", "bipartite"), WF: ("waterfill",)}


def stems_of(name):
    """The libraries a variant changes (the base: all of them)."""
    if not VARIANTS[name]:
        return ("fused_gru", "bipartite", "waterfill")
    return tuple(sorted({s for f, _, _ in VARIANTS[name]
                         for s in STEMS[f]}))


def build_variants(names):
    from repro_torch.kernels import build
    root = build.BUILD_ROOT / "variants"
    procs = []
    for name in names:
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        for fname, old, new in VARIANTS[name]:
            src = (d / fname).read_text()
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not once in {fname}")
            (d / fname).write_text(src.replace(old, new))
        for stem in stems_of(name):
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o",
                   str(d / f"lib{stem}.so"), str(d / f"{stem}.cu")]
            procs.append((name, stem, d, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    libs = {}
    for name, stem, d, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:             # reported, and skipped
            print(json.dumps({"variant": name, "nvcc_failed": stem,
                              "log": log[-2000:]}), flush=True)
            libs[name] = None
            continue
        spill = [ln.strip() for ln in log.splitlines() if "spill" in ln]
        if libs.get(name, {}) is not None:
            libs.setdefault(name, {})[stem] = (d / f"lib{stem}.so", spill)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=list(VARIANTS))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core.model import M4Config, init_m4
    from repro_torch.kernels import build
    from repro_torch.kernels.bipartite import ops as bip_ops
    from repro_torch.kernels.bipartite import ref as bip_ref
    from repro_torch.kernels.fused_gru import ops as gru_ops
    from repro_torch.kernels.fused_gru import ref as gru_ref
    from repro_torch.kernels.waterfill import layout as wf_layout
    from repro_torch.kernels.waterfill import ops as wf_ops
    from repro_torch.kernels.waterfill import ref as wf_ref
    from repro_torch.data.traffic import sample_scenario
    from repro_torch.sim import SimRequest

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    build.build_all()
    libs = build_variants(args.only)
    dev = torch.device("cuda")
    cfg = M4Config()
    params = init_m4(0, cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    H, G, C = cfg.hidden, cfg.gnn_dim, cfg.cfg_dim
    SF, SL, P = cfg.snap_flows, cfg.snap_links, cfg.max_path

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    gru_cases = []
    for stage, (kf, kl, df, dl) in {
            "stage1": ("gru1", "gruA", 1 + cfg.flow_feat + C,
                       1 + cfg.link_feat + C),
            "stage2": ("gru2", "gruB", G + C, G + C)}.items():
        xs = (randn(SF, df), torch.tanh(randn(SF, H)), randn(SL, dl),
              torch.tanh(randn(SL, H)))
        gru_cases.append((stage, params[kf], params[kl], xs))
    E = SF * P
    edge_f = torch.arange(SF, device=dev).repeat_interleave(P)
    gnn_cases = []
    for B, R in ((1, 3), (4, 3), (1, 1)):
        ins = (torch.relu(randn(B, SF, G)), torch.relu(randn(B, SL, G)),
               edge_f, torch.randint(0, SL, (B, E), generator=g, device=dev),
               (torch.rand(B, E, generator=g, device=dev) < 0.7).float())
        gnn_cases.append((f"B{B}_R{R}", params["gnn"][:R], ins))
    wf_cases = []
    for B, real in ((1, None), (4, [(2000, 96), (1200, 80), (600, 96),
                                    (1900, 80)])):
        wf_cases.append((f"B{B}_N2000_L96", *cs.event_case(
            torch, g, dev, B, 2000, 96, real)))
    req = SimRequest.from_scenario(sample_scenario(1))
    a, cap, picks = cs.flowsim_states(torch, np, dev, req)
    wf_cases.append(("real_most_rounds", a, cap, picks["most_rounds"][1]))

    for name in args.only:
        if libs[name] is None:
            continue
        for stem, (path, spill) in libs[name].items():
            build._LIBS[stem] = ctypes.CDLL(str(path))
        for case, a, cap, active in wf_cases:
            if "waterfill" not in libs[name]:
                break
            lists = wf_layout.incidence_lists(a)
            got = wf_ops.waterfill_event(lists, cap, active)
            want = wf_ref.waterfill_event_ref(a.double(), cap, active)
            ms = cs.device_ms(torch, lambda: wf_ops.waterfill_event(
                lists, cap, active))
            clocks = (got[0][:, :6].tolist() if name.endswith("_clocks")
                      else None)
            print(json.dumps({"variant": name, "kernel": "waterfill_event",
                              "case": case, "us": 1e3 * ms,
                              "phase_cycles": clocks,
                              "rounds": want[1].tolist(),
                              "max_abs_err": float((got[0] - want[0])
                                                   .abs().max()),
                              "bitwise": all(torch.equal(x, w) for x, w
                                             in zip(got, want)),
                              "spill": libs[name]["waterfill"][1]}),
                  flush=True)
        for stage, pf, pl, xs in gru_cases:
            if "fused_gru" not in libs[name]:
                break
            got = gru_ops.gru_pair(pf, pl, *xs)
            want = gru_ref.gru_pair_ref(pf, pl, *xs)
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            ms = cs.device_ms(torch, lambda: gru_ops.gru_pair(pf, pl, *xs))
            print(json.dumps({"variant": name, "kernel": "fused_gru_pair",
                              "case": stage, "us": 1e3 * ms,
                              "max_abs_err": err,
                              "spill": libs[name]["fused_gru"][1]}),
                  flush=True)
        for case, lys, ins in gnn_cases:
            if "bipartite" not in libs[name]:
                break
            got = bip_ops.bipartite_rounds(lys, *ins)
            want = ins[:2]
            for ly in lys:
                want = bip_ref.bipartite_round_ref(
                    *want, *ins[2:], ly["wf"]["w"], ly["wl"]["w"],
                    ly["wf"]["b"], ly["wl"]["b"])
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            ms = cs.device_ms(torch,
                              lambda: bip_ops.bipartite_rounds(lys, *ins))
            print(json.dumps({"variant": name, "kernel": "bipartite_rounds",
                              "case": case, "us": 1e3 * ms,
                              "max_abs_err": err,
                              "spill": libs[name]["bipartite"][1]}),
                  flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
