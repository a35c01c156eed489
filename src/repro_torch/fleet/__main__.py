"""CLI: run a scenario suite through a supervised worker fleet.

    PYTHONPATH=src python -m repro_torch.fleet --suite smoke16 --workers 3 \\
        --cache-dir results/fleet_cache
    PYTHONPATH=src python -m repro_torch.fleet --suite smoke16 \\
        --chaos "kill:worker=0,after=1;corrupt:task=5" --expect-clean
    PYTHONPATH=src python -m repro_torch.fleet --suite smoke16 \\
        --backend flowsim_fast --device cpu --workers 2 --expect-clean

The port of `python -m repro.fleet`: the same flags and exit rule, plus
`--device` (default cuda: flowsim_fast and m4 workers run on the card;
cpu runs the kernels' plain versions) and, for `--backend m4`, the
weight flags of `python -m repro_torch.scenarios` (`--ckpt-dir` and the
widths): m4 needs trained weights.

Exit status is the CI gate: nonzero unless every chunk is accounted for
(done + poisoned == total); `--expect-clean` additionally requires zero
poisoned chunks. `--metrics-out` writes the run's FleetMetrics JSON
(the fleet-chaos CI job uploads it as an artifact). `--chaos` defaults
from $REPRO_FLEET_CHAOS so wrappers can inject plans without arg
plumbing.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    from ..scenarios import SweepRunner, get_suite
    from ..scenarios.__main__ import _build_backend
    from .chaos import parse_plan
    from .supervisor import FleetConfig

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.fleet",
        description="Shard a scenario suite across supervised worker "
                    "processes with retry, poison quarantine, and "
                    "resume-from-cache.")
    ap.add_argument("--suite", required=True,
                    help="suite name (see python -m repro_torch.scenarios "
                         "--list)")
    ap.add_argument("--backend", default="flowsim_fast")
    ap.add_argument("--num-flows", type=int, default=None)
    ap.add_argument("--n", type=int, default=None,
                    help="scenario count for random suites")
    ap.add_argument("--limit", type=int, default=None,
                    help="run only the first K specs")
    ap.add_argument("--chunk", type=int, default=1,
                    help="scenarios per fleet chunk (default 1)")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--cache-dir", default="results/fleet_cache",
                    help="result cache (the fleet's shared result spine)")
    ap.add_argument("--coord-dir", default=None,
                    help="coordination dir (default: derived from the "
                         "cache dir + task-set digest)")
    ap.add_argument("--chaos",
                    default=os.environ.get("REPRO_FLEET_CHAOS", ""),
                    help='fault plan, e.g. "kill:worker=0,after=2;'
                         'corrupt:task=5" (see repro_torch.fleet.chaos)')
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--lease-timeout", type=float, default=5.0)
    ap.add_argument("--heartbeat", type=float, default=0.5)
    ap.add_argument("--max-attempts", type=int, default=3)
    ap.add_argument("--chunk-timeout", type=float, default=None,
                    help="hard per-chunk wall clock cap in seconds")
    ap.add_argument("--metrics-out", default=None,
                    help="write the FleetMetrics JSON here")
    ap.add_argument("--trace-dir",
                    default=os.environ.get("REPRO_TRACE_DIR", ""),
                    help="obs trace span directory (tracing on when "
                         "set; defaults from $REPRO_TRACE_DIR)")
    ap.add_argument("--expect-clean", action="store_true",
                    help="fail if any chunk was poisoned")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of flowsim_fast and m4 (default cuda; "
                         "cpu runs the kernels' plain versions)")
    # m4: where its weights are and their width (the scenarios CLI's)
    ap.add_argument("--ckpt-dir", default="results/m4_ckpt",
                    help="m4 checkpoint directory (default results/m4_ckpt)")
    ap.add_argument("--hidden", type=int, default=96)
    ap.add_argument("--gnn-dim", type=int, default=64)
    ap.add_argument("--mlp-hidden", type=int, default=64)
    ap.add_argument("--snap-flows", type=int, default=16)
    ap.add_argument("--snap-links", type=int, default=48)
    args = ap.parse_args(argv)

    knobs = {}
    if args.num_flows is not None:
        knobs["num_flows"] = args.num_flows
    if args.n is not None:
        knobs["n"] = args.n
    sweep = get_suite(args.suite, **knobs)
    if args.limit is not None:
        sweep = sweep.limit(args.limit)

    plan = parse_plan(args.chaos, seed=args.chaos_seed) \
        if args.chaos else None
    from ..runtime.resilience import Backoff
    config = FleetConfig(
        workers=args.workers, coord_dir=args.coord_dir,
        heartbeat_s=args.heartbeat, lease_timeout_s=args.lease_timeout,
        max_attempts=args.max_attempts, chaos=plan,
        chunk_timeout_s=args.chunk_timeout,
        backoff=Backoff(base_s=0.25, cap_s=10.0, seed=args.chaos_seed),
        trace_dir=args.trace_dir or None)
    if args.trace_dir:
        print(f"-- tracing to {args.trace_dir} "
              f"(render: python -m repro_torch.obs --dir {args.trace_dir})")

    backend = _build_backend(args)
    runner = SweepRunner(backend, cache_dir=args.cache_dir,
                         chunk_size=args.chunk or None, fleet=config)
    report = runner.run(sweep)
    print(report.table())

    # every scenario cached -> nothing dispatched: an all-zero record
    m = report.fleet or {
        "total": 0, "done": 0, "already_done": 0, "computed": 0,
        "poisoned": 0, "retried": 0, "stragglers": 0, "kills": 0,
        "lease_breaks": 0, "worker_restarts": 0, "workers_spawned": 0,
        "verify_requeues": 0, "wall_s": 0.0, "chaos": "", "poison": [],
        "accounted": 0}
    print(f"-- fleet: {m.get('done', 0)}/{m.get('total', 0)} done "
          f"({m.get('already_done', 0)} resumed), "
          f"{m.get('poisoned', 0)} poisoned, "
          f"{m.get('retried', 0)} retried, "
          f"{m.get('worker_restarts', 0)} restart(s), "
          f"{m.get('kills', 0)} kill(s), "
          f"{m.get('stragglers', 0)} straggler(s)")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(m, f, indent=1)
        print(f"-- metrics written to {args.metrics_out}")

    if m.get("accounted", 0) != m.get("total", 0):
        print(f"FAIL: {m['total'] - m['accounted']} unaccounted chunk(s)")
        return 1
    if args.expect_clean and m.get("poisoned", 0):
        print(f"FAIL: {m['poisoned']} poisoned chunk(s) under "
              "--expect-clean")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
