#!/usr/bin/env python
"""How far flowsim_fast's FCTs depend on the summation order of its two
link sums (flows per link, rate in use per link).

The port takes both sums exactly (float64, rounded once to float32). The
JAX reference takes them in float32 in an order XLA chooses. This script
runs the port's event loop on the CPU three times on one scenario — exact
sums, float32 sums in flow order, float32 sums in reverse flow order —
and prints, for each float32 variant against the exact one, the largest
relative FCT difference, the flows beyond 1e-4 and the first event whose
(fid, is_arrival) differs.

    PYTHONPATH=src python tools/flowsim_sum_order.py --flows 2000 --seed 1

`--threads` sets torch's CPU thread count: the float32 sums (and so the
float32 FCTs) depend on it too, the exact sums do not.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core import flowsim_fast as ff
from repro_torch.data.traffic import sample_scenario
from repro_torch.kernels.waterfill import ref as wf_ref


def float32_round(reverse: bool):
    """`wf_ref.waterfill_round_ref` with float32 link sums, flows in
    forward or reverse order."""
    def round_(a, cap, rates, frozen):
        unfrozen = ~frozen
        a = a.float()
        lhs = torch.stack([unfrozen.float(), rates * frozen], 1)
        if reverse:
            lhs, a = lhs.flip(-1), a.flip(1)
        n_l, used = torch.bmm(lhs, a).unbind(1)
        if reverse:
            a = a.flip(1)
        avail = torch.clamp_min(cap - used, 0.0)
        share = torch.where(n_l > 0, avail / n_l.clamp_min(1.0), ff.BIG)
        f_share = wf_ref.masked_rowmin_ref(a, share)
        theta = torch.where(unfrozen, f_share, ff.BIG).amin(-1, keepdim=True)
        newly = unfrozen & (f_share <= theta * ff.TIE)
        return torch.where(newly, f_share, rates), frozen | newly
    return round_


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--flows", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--threads", type=int, default=None)
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    sc = sample_scenario(args.seed, num_flows=args.flows)
    flows = sc.generate()
    arr = np.array([f.t_arrival for f in flows])
    packed = ff._to_device([ff._pack(sc.topo, flows)], "cpu")
    exact_round = wf_ref.waterfill_round_ref
    runs = {}
    for name, fn in (("exact", exact_round),
                     ("float32", float32_round(False)),
                     ("float32_reversed", float32_round(True))):
        wf_ref.waterfill_round_ref = fn
        t0 = time.perf_counter()
        fct, log = ff._event_scan_core(*packed, record=True)
        runs[name] = (fct[0].numpy() - arr, log, time.perf_counter() - t0)
    wf_ref.waterfill_round_ref = exact_round
    fct0, log0, _ = runs["exact"]
    for name in ("float32", "float32_reversed"):
        fct, log, wall = runs[name]
        rel = np.abs(fct - fct0) / np.abs(fct0)
        same = ((log["fid"] == log0["fid"])
                & (log["is_arrival"] == log0["is_arrival"]))[0].numpy()
        print(json.dumps({
            "seed": args.seed, "flows": args.flows, "variant": name,
            "threads": torch.get_num_threads(),
            "max_rel_fct_diff": float(rel.max()),
            "flows_beyond_1e-4": int((rel > 1e-4).sum()),
            "first_diverging_event": None if same.all()
            else int(np.argmin(same)),
            "capped_events_exact": int(log0["capped"].sum()),
            "wall_s_cpu": wall}))


if __name__ == "__main__":
    main()
