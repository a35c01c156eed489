"""CLI: run a named scenario suite and print a results table.

    PYTHONPATH=src python -m repro_torch.scenarios smoke16 --backend flowsim_fast
    PYTHONPATH=src python -m repro_torch.scenarios table2_train_space \\
        --backend m4 --n 16 --num-flows 200 --cache-dir results/sweep_cache
    PYTHONPATH=src python -m repro_torch.scenarios smoke16 --device cpu
    PYTHONPATH=src python -m repro_torch.scenarios --list

`flowsim_fast` and `m4` run on the card unless `--device cpu` is given;
without a card they raise. `--backend m4` restores trained weights from
`--ckpt-dir` (default results/m4_ckpt, where `python -m repro.train` and
the JAX package's benchmarks leave their model; `python -m
repro_torch.train` writes the same format), at the width flags
below. A missing checkpoint is an error: the sweep never trains at first
use and never runs random weights. The footer counts the compiled
programs the sweep built (the loops' `TRACE_COUNTS`: graph captures on a
card, prepared eager steps on the CPU).
"""
from __future__ import annotations

import argparse
import inspect
import sys


def _build_backend(args):
    from ..sim import get_backend
    if args.backend in ("packet", "flowsim"):
        return get_backend(args.backend)
    if args.backend != "m4":
        return get_backend(args.backend, device=args.device)
    from ..core.model import M4Config
    from ..train import load_state
    cfg = M4Config(hidden=args.hidden, gnn_dim=args.gnn_dim,
                   mlp_hidden=args.mlp_hidden, snap_flows=args.snap_flows,
                   snap_links=args.snap_links)
    state, done = load_state(args.ckpt_dir, cfg, device=args.device)
    if state is None:
        raise SystemExit(
            f"--backend m4 needs trained weights: no committed checkpoint "
            f"in {args.ckpt_dir}. Train one with `python -m "
            f"repro_torch.train --ckpt-dir {args.ckpt_dir}` (same width "
            "flags), or point --ckpt-dir at one")
    print(f"[scenarios] m4 weights {state.weights_hash()[:12]} from "
          f"{args.ckpt_dir} (epoch {done})")
    return get_backend("m4", params=state.params, cfg=cfg,
                       device=args.device)


def main(argv=None) -> int:
    from . import SUITES, SweepRunner, get_suite, list_suites
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.scenarios",
        description="Run a named scenario suite through one simulator "
                    "backend of the port and print a results table.")
    ap.add_argument("suite", nargs="?", help="suite name (see --list)")
    ap.add_argument("--list", action="store_true", help="list suites")
    ap.add_argument("--backend", default="flowsim_fast",
                    help="simulator backend (default: flowsim_fast)")
    ap.add_argument("--num-flows", type=int, default=None,
                    help="flows per scenario (suite default if omitted)")
    ap.add_argument("--n", type=int, default=None,
                    help="scenario count for random suites "
                         "(table2_train_space)")
    ap.add_argument("--limit", type=int, default=None,
                    help="run only the first K specs of the suite")
    ap.add_argument("--chunk", type=int, default=8,
                    help="scenarios per padded batch (default 8; "
                         "0 = one chunk for the whole sweep)")
    ap.add_argument("--cache-dir", default=None,
                    help="on-disk result cache directory (off by default)")
    ap.add_argument("--device", default="cuda",
                    help="device of flowsim_fast and m4 (default cuda; "
                         "cpu runs the kernels' plain versions)")
    # m4: where its weights are and their width (the benchmark's model)
    ap.add_argument("--ckpt-dir", default="results/m4_ckpt",
                    help="m4 checkpoint directory (default results/m4_ckpt)")
    ap.add_argument("--hidden", type=int, default=96)
    ap.add_argument("--gnn-dim", type=int, default=64)
    ap.add_argument("--mlp-hidden", type=int, default=64)
    ap.add_argument("--snap-flows", type=int, default=16)
    ap.add_argument("--snap-links", type=int, default=48)
    args = ap.parse_args(argv)

    if args.list or not args.suite:
        print("available suites:")
        for name in list_suites():
            print(f"  {name}")
        return 0 if args.list else 2

    knobs = {}
    if args.num_flows is not None:
        knobs["num_flows"] = args.num_flows
    if args.n is not None:
        knobs["n"] = args.n
    if args.suite in SUITES:
        # fail cleanly when a knob isn't one of this suite's parameters
        accepted = set(inspect.signature(SUITES[args.suite]).parameters)
        rejected = set(knobs) - accepted
        if rejected:
            raise SystemExit(
                f"suite {args.suite!r} does not take "
                f"{', '.join('--' + k.replace('_', '-') for k in sorted(rejected))} "
                f"(its knobs: {', '.join(sorted(accepted)) or 'none'})")
    sweep = get_suite(args.suite, **knobs)
    if args.limit is not None:
        sweep = sweep.limit(args.limit)

    from ..runtime.guards import trace_total
    runner = SweepRunner(_build_backend(args), cache_dir=args.cache_dir,
                         chunk_size=args.chunk or None)
    c0 = trace_total()
    report = runner.run(sweep)
    print(report.table())
    print(f"-- simulate {report.simulate_s:.2f}s for {report.misses} "
          "scenario(s)")
    print(f"-- compiles this run: {trace_total() - c0}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
