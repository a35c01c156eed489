"""CLI: `PYTHONPATH=src python -m repro_torch.analysis [--check] [paths...]`.

Modes, as `python -m repro.analysis`:
    (default)           print every finding (baselined ones marked)
    --check             the gate: exit 1 on unbaselined findings or
                        unjustified baseline entries; stale entries warn
    --update-baseline   rewrite the baseline from current findings,
                        keeping existing justifications (new entries get
                        "TODO: justify or fix", which --check rejects)
    --json PATH         machine-readable report (findings + partition)
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from . import (DEFAULT_BASELINE, DEFAULT_TARGETS, REPO_ROOT, analyze_paths,
               load_baseline, partition, save_baseline, unjustified)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis of the PyTorch/CUDA port")
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/dirs to scan (default: {DEFAULT_TARGETS})")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on unbaselined findings (the gate)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline path relative to the repo root "
                         "('' disables)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from current findings")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write a machine-readable JSON report")
    ap.add_argument("--root", default=REPO_ROOT, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    targets = args.paths or list(DEFAULT_TARGETS)
    findings = analyze_paths(targets, root=args.root)
    bl_path = None
    if args.baseline:
        bl_path = args.baseline if os.path.isabs(args.baseline) \
            else os.path.join(args.root, args.baseline)
    baseline = load_baseline(bl_path) if bl_path else {}
    new, known, stale = partition(findings, baseline)
    bad_entries = unjustified(baseline)

    if args.update_baseline:
        if not bl_path:
            ap.error("--update-baseline needs a baseline path")
        save_baseline(bl_path, findings, previous=baseline)
        print(f"[analysis] baseline rewritten: {len(findings)} entries "
              f"-> {bl_path}")
        return 0

    if args.json:
        report = {
            "targets": targets,
            "counts": {"total": len(findings), "new": len(new),
                       "baselined": len(known), "stale": len(stale)},
            "findings": [f.to_json() for f in findings],
            "new": [f.fingerprint for f in new],
            "stale": stale,
        }
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
        print(f"[analysis] report -> {args.json}")

    for f in new:
        print(f.render())
    if not args.check:
        for f in known:
            print(f"{f.path}:{f.line}: [{f.checker}] (baselined: "
                  f"{baseline[f.fingerprint].get('justification', '')})")
    for e in stale:
        print(f"[analysis] STALE baseline entry {e['fingerprint']} "
              f"({e['checker']} {e['path']}): code fixed — remove it")
    for e in bad_entries:
        print(f"[analysis] UNJUSTIFIED baseline entry {e['fingerprint']} "
              f"({e['checker']} {e['path']}): write a one-line reason")

    print(f"[analysis] {len(findings)} finding(s): {len(new)} new, "
          f"{len(known)} baselined, {len(stale)} stale entr(ies), "
          f"{len(bad_entries)} unjustified")
    if args.check and (new or bad_entries):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
