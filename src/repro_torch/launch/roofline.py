"""Roofline analysis, as `repro.launch.roofline`, with an H100 hardware
model.

The JAX package lowers each cell at two small depths L1 < L2 because
XLA's cost_analysis() counts `lax.scan` bodies once. The port's trace
(`dryrun.trace_cell`) runs every layer, so a direct count is exact at any
depth; the two-depth extrapolation is kept all the same, since two shallow
traces cost a fraction of a full-depth one and each layer adds the same
work, which makes it exact:

    per_layer = (X(L2) - X(L1)) / (L2 - L1)
    base      = X(L1) - L1 * per_layer          # embed/head/loss/optimizer
    total     = base + L_full * per_layer

Hardware model: one NVIDIA H100 SXM5 80GB at its 700 W limit.

    compute   = FLOPs_dev / peak
    memory    = bytes_dev / hbm_bw
    collective= collective_bytes_dev / link_bw

`bytes_dev` has no torch counterpart of XLA's fused "bytes accessed": it
is the sum of every local op's input and output bytes on one rank, an
unfused upper bound (each intermediate counted as a trip through HBM).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline --arch gemma2-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.roofline --all
"""
from __future__ import annotations

import argparse
import json
import os
import time

from .. import configs
from .dryrun import opt_overrides, trace_cell
from .mesh import init_fake_group, make_production_mesh

# NVIDIA H100 SXM5 data sheet: dense bf16 tensor-core rate (no sparsity)
PEAK_FLOPS = 989e12
# the same data sheet: HBM3 bandwidth of the 80 GB part
HBM_BW = 3.35e12
# per GPU for collectives: one 400 Gb/s NDR InfiniBand NIC per GPU (DGX
# H100); a 16-wide mesh axis spans two 8-GPU NVLink nodes, so the
# inter-node link sets the pace
LINK_BW = 50e9
CHIPS = 256


def _depths(cfg):
    if cfg.family == "hybrid":
        e = cfg.hybrid_attn_every
        return e, 2 * e
    if cfg.local_global:
        return 2, 4
    return 1, 2


def _lower_unrolled(cfg, shape, depth, mesh):
    """Trace the cell with `depth` layers; return (flops, bytes,
    coll_bytes) per device."""
    census, flops, _ = trace_cell(cfg.with_(num_layers=depth), shape, mesh)
    return float(flops), float(census.op_bytes), float(census.total)


def model_flops(cfg, shape):
    """MODEL_FLOPS convention: 6·N_active·tokens (train), 2·N_active·tokens
    (prefill/decode forward-only)."""
    S, B, kind = configs.SHAPES[shape]
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * S * B
    if kind == "prefill":
        return 2.0 * n * S * B
    return 2.0 * n * B  # decode: one token per sequence


def analyze_cell(arch, shape, dry_dir="results/dryrun", log=print,
                 optimized=False, *, cfg=None, mesh=None):
    """`cfg` and `mesh` default to the arch's config and the 16x16
    production mesh."""
    cfg = cfg or configs.get_config(arch)
    if not configs.shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape, "skipped": True}
    if optimized:
        cfg = opt_overrides(cfg, shape)
    if mesh is None:
        init_fake_group()
        mesh = make_production_mesh(multi_pod=False)
    l1, l2 = _depths(cfg)
    t0 = time.perf_counter()
    f1, b1, c1 = _lower_unrolled(cfg, shape, l1, mesh)
    f2, b2, c2 = _lower_unrolled(cfg, shape, l2, mesh)
    dl = l2 - l1
    per_layer = ((f2 - f1) / dl, (b2 - b1) / dl, (c2 - c1) / dl)
    base = (f1 - l1 * per_layer[0], b1 - l1 * per_layer[1],
            c1 - l1 * per_layer[2])
    L = cfg.num_layers
    tot_f = max(base[0] + L * per_layer[0], 0.0)
    tot_b = max(base[1] + L * per_layer[1], 0.0)
    tot_c = max(base[2] + L * per_layer[2], 0.0)

    t_comp = tot_f / PEAK_FLOPS
    t_mem = tot_b / HBM_BW
    t_coll = tot_c / LINK_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    hlo_global = tot_f * CHIPS
    useful = mf / (CHIPS * PEAK_FLOPS)
    rec = {
        "arch": arch, "shape": shape,
        "mesh": "x".join(str(n) for n in mesh.shape),
        "optimized": optimized,
        "depths_probed": [l1, l2],
        "flops_dev": tot_f, "bytes_dev": tot_b, "coll_bytes_dev": tot_c,
        "t_compute_s": t_comp, "t_memory_s": t_mem, "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": mf,
        "useful_ratio": mf / hlo_global if hlo_global else None,
        "roofline_fraction": useful / max(max(terms.values()), 1e-30),
        "analysis_s": round(time.perf_counter() - t0, 1),
    }
    log(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--optimized", action="store_true")
    ap.add_argument("--out", default="results/roofline")
    args = ap.parse_args(argv)
    archs = configs.list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(configs.SHAPES) if (args.all or not args.shape) else [args.shape]
    os.makedirs(args.out, exist_ok=True)
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}_{shape}" + ("_opt" if args.optimized else "")
            try:
                rec = analyze_cell(arch, shape, optimized=args.optimized)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"[roofline] {tag}: "
                      f"{'SKIP' if rec.get('skipped') else rec['dominant']}")
            except Exception as e:
                print(f"[roofline] {tag}: FAIL {e}")


if __name__ == "__main__":
    main()
