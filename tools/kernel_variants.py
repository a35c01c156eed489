#!/usr/bin/env python3
"""Time variants of the port's two tensor-core kernels on the card.

    python tools/kernel_variants.py [--only NAME ...]

Each variant is a copy of `src/repro_torch/kernels/csrc` with a few
source lines replaced (the GRU's depth split, the GNN's tile width or slab
depth, the TF32 rounding instruction, or a diagnostic that drops the mma,
a phase or two of the three TF32 terms). All variants build
in parallel, one `nvcc` per source, into `kernels/_build/variants/`; then
each is loaded in place of the built library, run through the wrappers
`fused_gru.ops.gru_pair` and `bipartite.ops.bipartite_rounds` at m4's full
width (`M4Config()`, `init_m4(0)` weights), held against the plain
versions (the error is reported, not enforced: the diagnostics are wrong
by design), and timed as `chip_smoke.py` times kernels (CUDA-graph
replay). One JSON line per variant and shape, and the card's nvidia-smi
line. Needs an NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

GRU, GNN, HDR = "fused_gru.cu", "bipartite.cu", "tf32x3.cuh"
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
}


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
            if old not in src:
                raise RuntimeError(f"{name}: {old!r} not in {fname}")
            (d / fname).write_text(src.replace(old, new))
        for stem in ("fused_gru", "bipartite"):
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

    for name in args.only:
        if libs[name] is None:
            continue
        for stem, (path, spill) in libs[name].items():
            build._LIBS[stem] = ctypes.CDLL(str(path))
        for stage, pf, pl, xs in gru_cases:
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
