#!/usr/bin/env python3
"""The readings that the comparison's limits are set from, for one cell,
on the card, at the cell's own sizes: per seed, the program's numbers
(each pool batch through `run_many`, the timed path, against the plain
reference) and the control's (the reference in the precision below the
configuration's, in the program's place).

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--control-seeds 1 2 3] [--fresh-points] [--out calibrate.jsonl]

`--fresh-points` draws each seed's scenarios from the seed itself in
place of the mix's `points_seed`: the readings on fresh scenarios,
beside those on the mix's own, which every run of the benchmark uses.

One process reads every seed, so set-up is paid once; the program's
captured programs are dropped between seeds. The benchmark's runs never
call this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def quantiles(per):
    """Quantiles of all flows' relative gaps, and of the answers'
    medians."""
    import numpy as np
    rel = np.concatenate(per)
    med = np.array([np.median(r) for r in per])
    out = {f"q{q:g}": float(np.quantile(rel, q))
           for q in (0.5, 0.9, 0.99, 0.999, 1.0)}
    out["answer_medians"] = med.tolist()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    ap.add_argument("--fresh-points", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench.harness import check, gen, lanes, spec
    from portbench.harness import weights as weights_mod
    from repro_torch.core import compiled

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cell = spec.find_cell(spec.load_benchmark(), args.workload, False)
    cfg, traffic = cell.config, cell.traffic
    lane = lanes.lane(traffic, cfg)
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.fresh_points:
            traffic = dict(traffic, points_seed=seed)
        pool = gen.pool(cfg, traffic, seed)
        weights = (weights_mod.make(cfg["model"], seed, dev)
                   if lane.name == "m4" else None)
        backend = lane.backend(weights, dev)
        outs = [(k, [r.fcts for r in backend.run_many(lanes.requests(b))])
                for k, b in enumerate(pool)]
        del backend
        compiled.clear_compiled()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        refs = {k: lane.reference(b, weights, dev)[0]
                for k, b in enumerate(pool)}
        t2 = time.perf_counter()
        rec = {"workload": cell.name, "seed": seed, "side": "program",
               "points_seed": traffic["points_seed"],
               **check.numbers(outs, refs),
               **quantiles(check.gaps(outs, refs)),
               "program_s": t1 - t0, "reference_s": t2 - t1}
        if seed in args.control_seeds:
            ctrl = [(k, lane.reference(b, weights, dev, control=True)[0])
                    for k, b in enumerate(pool)]
            crec = {"workload": cell.name, "seed": seed, "side": "control",
                    **check.numbers(ctrl, refs),
                    **quantiles(check.gaps(ctrl, refs)),
                    "control_s": time.perf_counter() - t2}
            recs = [rec, crec]
        else:
            recs = [rec]
        for r in recs:
            line = json.dumps(r)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
