"""CLI: train m4 on a named scenario suite, end to end, on the card.

    PYTHONPATH=src python -m repro_torch.train --suite smoke16
    PYTHONPATH=src python -m repro_torch.train --suite table2_train_space \\
        --n 32 --num-flows 200 --epochs 20
    PYTHONPATH=src python -m repro_torch.train --suite smoke16 --device cpu
    PYTHONPATH=src python -m repro_torch.train --suite smoke16 --data-key

The flags are `python -m repro.train`'s, plus `--device` (default cuda;
without a card it raises, `--device cpu` runs the plain versions). The
run is resumable by construction: kill it at any point and re-invoke the
identical command — it restores the last committed checkpoint from
--ckpt-dir and finishes with the weights of an uninterrupted run.
Dataset shards, packet ground truth for eval, and checkpoints all live
under --workdir (results/ by default) and are content-hash cached, so a
second run is pure cache hits; the shards and the ground truth share
their keys (and bytes) with the JAX package's stores. `--data-key` prints
the corpus content hash, the JAX CLI's for the same flags, and exits.
`--workers` above 1 raises: the dataset worker pool is not ported.
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.train",
        description="Train m4 on a scenario suite with the cached-dataset "
                    "bucketed pipeline of the PyTorch port.")
    ap.add_argument("--suite", default="smoke16",
                    help="training suite name (repro_torch.scenarios; "
                         "default smoke16)")
    ap.add_argument("--n", type=int, default=None,
                    help="scenario count for random suites")
    ap.add_argument("--num-flows", type=int, default=None,
                    help="flows per scenario (suite default if omitted)")
    ap.add_argument("--limit", type=int, default=None,
                    help="use only the first K specs of the suite")
    ap.add_argument("--max-events", type=int, default=None,
                    help="cap ground-truth events per sim")
    ap.add_argument("--workers", type=int, default=0,
                    help="worker processes for dataset generation "
                         "(0 = inline; more raises: not ported)")
    # model (CI-scale defaults; paper scale is hidden 400/gnn 300/mlp 200)
    ap.add_argument("--hidden", type=int, default=96)
    ap.add_argument("--gnn-dim", type=int, default=64)
    ap.add_argument("--mlp-hidden", type=int, default=64)
    ap.add_argument("--snap-flows", type=int, default=16)
    ap.add_argument("--snap-links", type=int, default=48)
    # optimization
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default="warmcos",
                    choices=["warmcos", "const"])
    ap.add_argument("--bucket", type=int, default=8,
                    help="sims per bucket (default 8)")
    ap.add_argument("--step-mode", default="per_sim",
                    choices=["per_sim", "batch"],
                    help="per_sim: one update per sim (seed-faithful); "
                         "batch: bucket-averaged gradients")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ablate-size", action="store_true",
                    help="zero the remaining-size head loss (Table 5)")
    ap.add_argument("--ablate-queue", action="store_true",
                    help="zero the queue-length head loss (Table 5)")
    # persistence + eval
    ap.add_argument("--workdir", default="results",
                    help="root for data/ckpt/log outputs (default results)")
    ap.add_argument("--data-dir", default=None,
                    help="dataset store (default <workdir>/train_data)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoints (default <workdir>/train_ckpt/"
                         "<suite>); 'none' disables")
    ap.add_argument("--ckpt-every", type=int, default=1)
    ap.add_argument("--fresh", action="store_true",
                    help="ignore existing checkpoints (start from scratch)")
    ap.add_argument("--eval-suite", default="table3_empirical",
                    help="held-out eval suite ('none' disables)")
    ap.add_argument("--eval-n", type=int, default=None,
                    help="limit eval suite to first K specs")
    ap.add_argument("--eval-flows", type=int, default=None,
                    help="flows per eval scenario (default: --num-flows)")
    ap.add_argument("--out", default=None,
                    help="train log path (default <workdir>/train_log.json)")
    ap.add_argument("--data-key", action="store_true",
                    help="print the corpus content hash and exit (CI "
                         "artifact-cache key)")
    ap.add_argument("--device", default="cuda",
                    help="device to train and evaluate on (default cuda; "
                         "cpu runs the kernels' plain versions)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import os
    import shutil

    from ..core.model import M4Config
    from ..scenarios import get_suite
    from . import (TrainConfig, dataset_key, train_suite, write_train_log)

    m4cfg = M4Config(hidden=args.hidden, gnn_dim=args.gnn_dim,
                     mlp_hidden=args.mlp_hidden, snap_flows=args.snap_flows,
                     snap_links=args.snap_links)
    knobs = {}
    if args.num_flows is not None:
        knobs["num_flows"] = args.num_flows
    if args.n is not None:
        knobs["n"] = args.n
    suite = get_suite(args.suite, **knobs)
    if args.limit is not None:
        suite = suite.limit(args.limit)

    if args.data_key:
        print(dataset_key(suite, m4cfg, max_events=args.max_events))
        return 0

    data_dir = args.data_dir or os.path.join(args.workdir, "train_data")
    ckpt_dir = args.ckpt_dir
    if ckpt_dir is None:
        ckpt_dir = os.path.join(args.workdir, "train_ckpt", suite.name)
    if ckpt_dir == "none":
        ckpt_dir = None
    if args.fresh and ckpt_dir and os.path.isdir(ckpt_dir):
        shutil.rmtree(ckpt_dir)

    tc = TrainConfig(
        epochs=args.epochs, lr=args.lr, schedule=args.schedule,
        bucket_size=args.bucket, step_mode=args.step_mode, seed=args.seed,
        w_size=0.0 if args.ablate_size else 1.0,
        w_queue=0.0 if args.ablate_queue else 1.0,
        ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every)

    eval_specs = None
    if args.eval_suite and args.eval_suite != "none":
        ek = {}
        ef = args.eval_flows or args.num_flows
        if ef is not None:
            ek["num_flows"] = ef
        eval_suite = get_suite(args.eval_suite, **ek)
        if args.eval_n is not None:
            eval_suite = eval_suite.limit(args.eval_n)
        eval_specs = list(eval_suite)

    state, report = train_suite(
        suite, m4cfg, tc, data_root=data_dir, workers=args.workers,
        max_events=args.max_events, eval_specs=eval_specs,
        eval_cache_dir=os.path.join(args.workdir, "sweep_cache"),
        device=args.device, log=print)
    out = args.out or os.path.join(args.workdir, "train_log.json")
    write_train_log(report, out)
    print(f"[train] done: {state.step} updates, "
          f"weights {report['weights_hash'][:12]}, log -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
