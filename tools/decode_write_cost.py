#!/usr/bin/env python3
"""The cost of the KV cache's one-token write in the LM's eager decode,
on the card: zamba2-2.7b at its full configuration (54 layers, d 2560,
bf16, `torch.Generator` seed 0), B 2, through `models.lm.serve_step`,
with the port's write (`nn/attention.py: _write`, a `torch.where`
against the slot's position) and with an out-of-place `index_copy` at
`cache_len` in its place (the write before the clamp past `max_len`),
alternating which runs first in each pair.

    python tools/decode_write_cost.py [--pairs 5] [--steps 64] [--max-len 64]

Prints one JSON line: per pair and side the ms per decode step (CUDA
synchronised wall over `--steps` steps from an empty cache of
`--max-len` slots), their medians, the CUDA kernels per step of each
side (torch.profiler over 4 steps), and the card's name and power limit.
Needs an NVIDIA GPU; `--max-len` at least `--steps`.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def index_copy_write(k_cache, v_cache, k, v, cache_len):
    idx = cache_len.reshape(1).long()
    return k_cache.index_copy(1, idx, k), v_cache.index_copy(1, idx, v)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_write_cost: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.nn import attention

    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--max-len", type=int, default=64)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = configs.get_config("zamba2-2.7b")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab, (2, args.steps), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(1))
    writes = {"where": attention._write, "index_copy": index_copy_write}

    def decode(n):
        st = lm.init_decode_state(cfg, 2, args.max_len, device=dev)
        for t in range(n):
            st, _ = lm.serve_step(params, cfg, st,
                                  {"tokens": tokens[:, t:t + 1]})

    def ms_per_step(name):
        attention._write = writes[name]
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode(args.steps)
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / args.steps
        finally:
            attention._write = writes["where"]

    def kernels_per_step(name):
        attention._write = writes[name]
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                decode(4)
                torch.cuda.synchronize()
        finally:
            attention._write = writes["where"]
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
        return n / 4 if n else None

    with torch.no_grad():
        for name in writes:                            # warm-ups
            ms_per_step(name)
        runs = {name: [] for name in writes}
        order = list(writes)
        for i in range(args.pairs):
            for name in (order if i % 2 == 0 else order[::-1]):
                runs[name].append(ms_per_step(name))
        kernels = {name: kernels_per_step(name) for name in writes}
    print(json.dumps({
        "arch": cfg.name, "batch": 2, "steps": args.steps,
        "max_len": args.max_len, "ms_per_step": runs,
        "median_ms_per_step": {k: statistics.median(v)
                               for k, v in runs.items()},
        "cuda_kernels_per_step": kernels, "card": smi,
        "torch": torch.__version__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
