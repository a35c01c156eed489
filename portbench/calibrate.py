#!/usr/bin/env python3
"""The readings that the comparison's limits are set from, for one cell,
on the card, at the cell's own sizes: per seed, the program's numbers
(one call of the cell's lane on each pool batch, the timed path,
against the plain reference) and the control's (the reference in the
precision below the configuration's, in the program's place); for the
LM lane also a witness's (the reference with bfloat16 products, the
configuration's own precision, in the program's place).

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--control-seeds 1 2 3] [--witness-seeds 1 2] [--fresh-points] \
        [--out calibrate.jsonl]

`--fresh-points` draws each seed's inputs from the seed itself in place
of the mix's `points_seed`: the readings on fresh inputs, beside those
on the mix's own, which every run of the benchmark uses.

One process reads every seed, so set-up is paid once; the lane releases
the program's state between seeds. The benchmark's runs never call
this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    ap.add_argument("--witness-seeds", type=int, nargs="*", default=())
    ap.add_argument("--fresh-points", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench.harness import check, lanes, spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cell = spec.find_cell(spec.load_benchmark(), args.workload, False)
    traffic = cell.traffic
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.fresh_points:
            traffic = dict(traffic, points_seed=seed)
        lane = lanes.lane(traffic, cell.config, cell.root)
        pool = lane.pool(seed)
        weights = lane.weights(seed, dev)
        backend = lane.backend(weights, dev)
        inputs = [lane.inputs(b, dev) for b in pool]
        t_in = time.perf_counter()
        outs = [(k, lane.call(backend, x)[0]) for k, x in enumerate(inputs)]
        del inputs
        lane.release(backend)
        del backend
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        refs = {k: lane.reference(b, weights, dev)[0]
                for k, b in enumerate(pool)}
        t2 = time.perf_counter()
        rec = {"workload": cell.name, "seed": seed, "side": "program",
               "points_seed": traffic["points_seed"],
               **lane.numbers(outs, refs), **lane.quantiles(outs, refs),
               "inputs_s": t_in - t0, "program_s": t1 - t_in,
               "reference_s": t2 - t1}
        recs = [rec]
        for side, seeds, kw in (("control", args.control_seeds,
                                 {"control": True}),
                                ("witness", args.witness_seeds,
                                 {"bf16": True})):
            if seed not in seeds:
                continue
            t3 = time.perf_counter()
            got = [(k, lane.reference(b, weights, dev, **kw)[0])
                   for k, b in enumerate(pool)]
            recs.append({"workload": cell.name, "seed": seed, "side": side,
                         **lane.numbers(got, refs),
                         **lane.quantiles(got, refs),
                         "seconds": time.perf_counter() - t3})
        rec["checks"] = {k: c["ok"] for k, c in
                         check.judge(rec, cell.limits).items()}
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
