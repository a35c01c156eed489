#!/usr/bin/env python3
"""The benchmark of the port (`src/repro_torch`) on NVIDIA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of `BENCHMARK.json` from the root of a checkout through
its lane (`portbench/lanes/<lane>.py`): set-up (inputs and weights from
the seed, a warm-up that captures every program the window runs), a
window of `--seconds`, the comparison with the plain reference, and one
JSON line, the last of standard output, with
`correct`, `attempted`, `failed`, `metrics` and `device` (and, traced,
`breakdown`), then `checks`: each number compared with its limit, which
are also the last lines of standard error. `--trace 0` reports the
cell's end-to-end metrics, `--trace 1` its per-layer ones from a
profiled window. Without a CUDA device, or without the port beside the
benchmark, it exits non-zero and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench-cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: no port (src/repro_torch) beside the benchmark",
              file=sys.stderr)
        return 2
    # every build and kernel cache inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.harness import runner, spec

    cell = spec.find_cell(spec.load_benchmark(), args.workload,
                          bool(args.trace))
    result, checks = runner.execute(
        cell, args.seed, args.seconds, bool(args.trace), T_START,
        log=lambda s: print(f"portbench: {s}", file=sys.stderr, flush=True))
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(runner.line(result, checks), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
