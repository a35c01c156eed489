#!/usr/bin/env python
"""Host throughput of the port's zstd decoder (`repro_torch/runtime/zstd.py`)
on a checkpoint that the JAX package writes with `zstandard` (level 3):
the `TrainState` (params and AdamW moments) at `M4Config()` width.

    PYTHONPATH=src python tools/zstd_throughput.py [--repeats 3]

Prints one JSON line: the payload and compressed sizes, whether the
decoder's bytes equal `zstandard`'s, and the best of `--repeats` wall
times with its MB/s of decompressed output (host CPU time, no device),
beside `zstandard`'s own. Needs jax and zstandard, as the parity tests do.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import tempfile
import time

import zstandard

from repro.core.model import M4Config
from repro.runtime import checkpoint as jck
from repro.train import init_state
from repro_torch.runtime.zstd import decompress


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as d:
        jck.save(d, 1, init_state(M4Config(), seed=0).tree())
        with open(os.path.join(d, "step_0000000001", "state.msgpack.zst"),
                  "rb") as f:
            comp = f.read()
    want = zstandard.ZstdDecompressor().decompress(comp)

    def best(fn):
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            out = fn(comp)
            times.append(time.perf_counter() - t0)
        return out, min(times)

    got, t = best(decompress)
    _, t_ref = best(zstandard.ZstdDecompressor().decompress)
    print(json.dumps({
        "what": "JAX TrainState checkpoint, M4Config() width, zstd level 3",
        "raw_bytes": len(want), "compressed_bytes": len(comp),
        "bitwise_equal": got == want, "seconds": t,
        "mb_per_s": len(want) / t / 1e6, "zstandard_seconds": t_ref,
        "zstandard_mb_per_s": len(want) / t_ref / 1e6,
        "host": platform.processor() or platform.machine(),
        "cpus": os.cpu_count(), "device": "host CPU (no accelerator)"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
