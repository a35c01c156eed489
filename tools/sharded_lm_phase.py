#!/usr/bin/env python3
"""Run the sharded and lm cells of chip_smoke.py alone on the card.

    python tools/sharded_lm_phase.py

Builds the kernels, then runs chip_smoke.py's `sharded` phase (m4 at
full width and flowsim_fast `run_many` of four 2000-flow scenarios in
two shards on one card against the batched path, and one sharded
batch-mode training update against the unsharded one) and its `lm`
phase (zamba2-2.7b at its full configuration: prefill, decode, decode
against the forward's prefix, and the card against the CPU in float32).
The batched programs of the four scenarios are captured first, as
chip_smoke.py's `full` phase leaves them. The same JSON lines as
chip_smoke.py, in ~1.5 minutes: the quickest way to iterate on these two
cells. Needs an NVIDIA GPU.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sharded_lm_phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core.model import M4Config, init_m4
    from repro_torch.data.traffic import sample_scenario
    from repro_torch.kernels import build
    from repro_torch.sim import SimRequest, get_backend

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    build.build_all()
    cs.emit("build", seconds=time.perf_counter() - t0)
    dev = torch.device("cuda")
    cfg = M4Config()
    m4 = get_backend("m4", params=init_m4(0, cfg, device=dev), cfg=cfg)
    fs = get_backend("flowsim_fast")
    reqs = [SimRequest.from_scenario(sample_scenario(s)) for s in range(4)]
    for backend in (m4, fs):                  # warm-ups, not counted
        backend.run(SimRequest.from_scenario(sample_scenario(
            7, num_flows=20)))
        backend.run_many(reqs)
    launches = cs.phase_sharded(torch, np, m4, fs, cfg, dev, smi)
    cs.phase_lm(torch, np, dev, smi)
    cs.emit("sharded", step="launches", launches=launches)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
