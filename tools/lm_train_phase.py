#!/usr/bin/env python3
"""Run the lm_train cell of chip_smoke.py alone on the card.

    python tools/lm_train_phase.py

chip_smoke.py's `lm_train` phase: zamba2-2.7b at its published size
through `repro_torch.launch.train.train` (4 steps timed, peak memory, leaf
dtypes), a crash and resume at one shared-attention group with the
checkpoint's bytes and walls, here at zamba2's own width (a ~4.9 GB
checkpoint: minutes of the host's zlib, which chip_smoke.py's time limit
does not hold, so it runs its resume at d_model LM_RESUME_D_MODEL),
the compressed step, the card against the CPU in
float32, examples/train_lm_torch.py --ci, and the dry-run's `gemma2-9b
train_4k 16x16` cell with its roofline. The phase launches no kernel of
the port, so nothing is built. The same JSON lines as chip_smoke.py, in
about ten minutes: the quickest way to iterate on this cell. Needs an
NVIDIA GPU.
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("lm_train_phase: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.emit("card", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
            torch=torch.__version__, cuda=torch.version.cuda)
    cs.phase_lm_train(torch, np, torch.device("cuda"), smi)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
