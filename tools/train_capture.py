#!/usr/bin/env python3
"""Time m4's compiled training step against its eager twin on the card.

    python tools/train_capture.py [--events 200 2000] [--flows 1000]

At full width (`M4Config()`, `init_state(0)` weights), on the packet-DES
ground truth of `random_spec(0, num_flows=--flows)` cut to each of
`--events` events: one bucket of that sim and its copy (B = 2) through
`train.loop.make_bucket_step` in each step mode. The first call builds the
program (warm-up, capture and instantiation of one CUDA graph of the
update, their walls from `core.compiled.entries()`), a second replays it,
and the same two calls under `core.compiled.eager()` run the eager step
from the same state: weights, moments and outputs must be bitwise equal.
One JSON line per (mode, events): walls, seconds per update, the graph
pool's bytes, peak device memory; then the card's nvidia-smi line. Needs
an NVIDIA GPU; builds no kernel (the differentiated step runs the plain
versions).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--events", type=int, nargs="+", default=[200, 2000])
    ap.add_argument("--flows", type=int, default=1000)
    ap.add_argument("--modes", nargs="+", default=["per_sim", "batch"])
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("train_capture: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import compiled
    from repro_torch.core.model import M4Config
    from repro_torch.scenarios import random_spec
    from repro_torch.train import (TRACE_COUNTS, TrainConfig, build_dataset,
                                   init_state)
    from repro_torch.train.batching import stack_bucket
    from repro_torch.train.loop import _make_schedule, make_bucket_step
    from repro_torch.weights import tree_digest

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = M4Config()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as store:
        (batch,), _ = build_dataset([random_spec(0, num_flows=args.flows)],
                                    cfg, store, log=lambda *a: None)
    print(json.dumps({"step": "ground_truth", "flows": args.flows,
                      "events": batch.num_events,
                      "seconds": time.perf_counter() - t0}), flush=True)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    for k in args.events:
        cut = batch.head(k)
        bb = {n: v.to(dev) for n, v in stack_bucket([cut, cut]).items()}
        for mode in args.modes:
            tc = TrainConfig(step_mode=mode)
            updates = 2 if mode == "per_sim" else 1
            st = init_state(cfg, 0, dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            step = make_bucket_step(cfg, tc, _make_schedule(tc, 4))
            c0 = TRACE_COUNTS["train_step"]
            (p1, o1, y1), first_s = timed(
                lambda: step(st.params, st.opt, bb))
            (p2, o2, y2), replay_s = timed(lambda: step(p1, o1, bb))
            (entry,) = [e for e in compiled.entries()
                        if e["entry"] == "train_step" and e["calls"] == 2]
            peak = torch.cuda.max_memory_allocated()
            programs = TRACE_COUNTS["train_step"] - c0
            del step
            torch.cuda.empty_cache()
            with compiled.eager():
                (q1, r1, z1), eager_s = timed(lambda: make_bucket_step(
                    cfg, tc, _make_schedule(tc, 4))(st.params, st.opt, bb))
                (q2, r2, z2), eager2_s = timed(lambda: make_bucket_step(
                    cfg, tc, _make_schedule(tc, 4))(q1, r1, bb))
            bitwise = (tree_digest({"p": p2, "o": o2}) ==
                       tree_digest({"p": q2, "o": r2})
                       and torch.equal(y1, z1) and torch.equal(y2, z2))
            print(json.dumps({
                "step": "train_capture", "mode": mode, "events": k,
                "sims": 2, "updates_per_call": updates,
                "programs": programs, "first_call_s": first_s,
                "warmup_s": entry["warmup_s"],
                "capture_s": entry["capture_s"],
                "instantiate_s": entry["instantiate_s"],
                "replay_call_s": replay_s,
                "s_per_update_replayed": replay_s / updates,
                "eager_call_s": eager2_s, "eager_first_call_s": eager_s,
                "s_per_update_eager": eager2_s / updates,
                "speedup": eager2_s / replay_s,
                "pool_bytes": entry["pool_bytes"],
                "buffer_bytes": entry["buffer_bytes"],
                "peak_memory_bytes": peak, "bitwise": bitwise,
                "card": smi}), flush=True)
            del p1, o1, p2, o2, q1, r1, q2, r2
            if not bitwise:
                raise AssertionError(f"{mode} K={k}: replay != eager")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
