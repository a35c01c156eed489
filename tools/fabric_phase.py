#!/usr/bin/env python3
"""Run the §5.2 fabric cell of chip_smoke.py alone on the card.

    python tools/fabric_phase.py

Builds the kernels, then runs chip_smoke.py's functions for the fabric:
the per-event water-filling against its plain version on the real states
of a 2000-flow run on `meta_fabric()` (18432 links: the device-memory
placement), then the `fabric` phase (m4 at full width and flowsim_fast
captured against eager at 2000 flows, profiles, one captured run each at
10000 flows, the card against the CPU at 200 flows) and the `files`
phase (a bfloat16 checkpoint and a legacy blob). The same JSON lines as
chip_smoke.py, in ~3 minutes instead of the whole script's ~13-15: the
quickest way to iterate on the fabric cell. Needs an NVIDIA GPU.
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
        print("fabric_phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core.model import M4Config, init_m4
    from repro_torch.data.traffic import sample_scenario
    from repro_torch.kernels import build
    from repro_torch.net import meta_fabric
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
    params = init_m4(0, cfg, device=dev)

    def req_of(seed, **kw):
        return SimRequest.from_scenario(sample_scenario(seed, **kw))

    cs.phase_event(torch, np, dev, req_of(1), req_of(
        0, num_flows=cs.FABRIC_FLOWS, topo=meta_fabric()))
    m4 = get_backend("m4", params=params, cfg=cfg)
    fs = get_backend("flowsim_fast")
    for backend in (m4, fs):                  # warm-ups, not counted
        backend.run(req_of(7, num_flows=20))
    launches = cs.phase_fabric(torch, np, m4, fs, params, cfg, dev, smi)
    cs.phase_files(torch, np, dev)
    cs.emit("fabric", step="launches", launches=launches)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
