"""CLI: aggregate obs snapshots and render traces from span JSONL.

    python -m repro_torch.obs --dir results/obs_trace --list
    python -m repro_torch.obs --dir results/obs_trace --trace <id>
    python -m repro_torch.obs --dir results/obs_trace --flame
    python -m repro_torch.obs --dir results/obs_trace --check
    python -m repro_torch.obs --merge snapA.json snapB.json [--prom]

The port of `python -m repro.obs`; it reads span, series and snapshot
files of either package. ``--check`` is the gate: every trace must have a
closed root span, children must nest inside their root's window, and
direct children must not overlap nor sum to more than the root wall.
Probe time-series files (``*.probes.jsonl``, written by probed runs /
`repro_torch.obs.diff`) found under ``--dir`` are structurally validated
by ``--check`` and summarized by ``--flame``; a directory holding only
probe files is valid without spans. (The JAX package's ``--coord``, which
stitches fleet tasks into their traces, waits for the port's fleet.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

from .export import to_prometheus
from .registry import merge_snapshots
from .trace import read_spans, spans_by_trace

_EPS = 2e-3  # seconds of cross-thread clock slack tolerated by --check


def _dur(rec: dict) -> float:
    t0 = rec.get("t_start") or 0.0
    t1 = rec.get("t_end") or t0
    return max(0.0, t1 - t0)


def _roots(recs: List[dict]) -> List[dict]:
    return [r for r in recs if r.get("parent_id") is None]


def _children(recs: List[dict]) -> Dict[Optional[str], List[dict]]:
    by_parent: Dict[Optional[str], List[dict]] = {}
    for r in recs:
        by_parent.setdefault(r.get("parent_id"), []).append(r)
    for v in by_parent.values():
        v.sort(key=lambda r: r.get("t_start") or 0.0)
    return by_parent


def cmd_list(spans: List[dict]) -> int:
    traces = spans_by_trace(spans)
    if not traces:
        print("no traces found")
        return 0
    print(f"{len(traces)} trace(s):")
    for tid in sorted(traces):
        recs = traces[tid]
        roots = _roots(recs)
        name = roots[0]["name"] if roots else "?"
        wall = max((_dur(r) for r in roots), default=0.0)
        print(f"  {tid}  root={name:<16} spans={len(recs):<4} "
              f"wall={wall * 1e3:.2f}ms")
    return 0


def _render_tree(rec: dict, by_parent: Dict, t_root: float,
                 depth: int) -> None:
    t0 = rec.get("t_start") or 0.0
    attrs = rec.get("attrs") or {}
    extra = " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
    pad = "  " * depth
    print(f"{pad}{rec.get('name'):<24} +{(t0 - t_root) * 1e3:8.2f}ms "
          f"{_dur(rec) * 1e3:8.2f}ms  {rec.get('status')}"
          + (f"  {extra}" if extra else ""))
    for child in by_parent.get(rec.get("span_id"), []):
        _render_tree(child, by_parent, t_root, depth + 1)


def cmd_trace(spans: List[dict], trace_id: str) -> int:
    traces = spans_by_trace(spans)
    recs = traces.get(trace_id)
    if recs is None:
        # allow matching on a prefix (ids are long)
        hits = [t for t in traces if t.startswith(trace_id)]
        if len(hits) == 1:
            trace_id, recs = hits[0], traces[hits[0]]
    if recs is None:
        print(f"trace {trace_id!r} not found", file=sys.stderr)
        return 1
    by_parent = _children(recs)
    roots = _roots(recs)
    print(f"trace {trace_id}  ({len(recs)} spans)")
    for root in roots:
        _render_tree(root, by_parent, root.get("t_start") or 0.0, 1)
    orphans = [r for r in recs
               if r.get("parent_id") is not None
               and not any(p.get("span_id") == r.get("parent_id")
                           for p in recs)]
    for o in orphans:
        print(f"  (orphan) {o.get('name')}  {_dur(o) * 1e3:.2f}ms")
    return 0


def _probe_files(dirpath: Optional[str]) -> List[str]:
    """Every ``*.probes.jsonl`` under `dirpath`, recursively."""
    if not dirpath or not os.path.isdir(dirpath):
        return []
    out = []
    for root, _dirs, files in os.walk(dirpath):
        for fname in files:
            if fname.endswith(".probes.jsonl"):
                out.append(os.path.join(root, fname))
    return sorted(out)


def cmd_flame(spans: List[dict], dirpath: Optional[str] = None) -> int:
    agg: Dict[str, List[float]] = {}
    for r in spans:
        agg.setdefault(r.get("name") or "?", []).append(_dur(r))
    total = sum(sum(v) for v in agg.values()) or 1.0
    print(f"{'name':<28} {'calls':>6} {'total_ms':>10} {'mean_ms':>9} "
          f"{'share':>6}")
    for name in sorted(agg, key=lambda n: -sum(agg[n])):
        durs = agg[name]
        tot = sum(durs)
        print(f"{name:<28} {len(durs):>6} {tot * 1e3:>10.2f} "
              f"{tot / len(durs) * 1e3:>9.3f} {tot / total:>6.1%}")
    probe_files = _probe_files(dirpath)
    if probe_files:
        from .timeseries import read_series_jsonl, summarize_series
        print(f"\n{len(probe_files)} probe series:")
        print(f"{'file':<44} {'backend':<14} {'samples':>7}  channels")
        for path in probe_files:
            try:
                s = summarize_series(read_series_jsonl(path))
            except Exception as e:                          # noqa: BLE001
                print(f"{os.path.basename(path):<44} <unreadable: {e}>")
                continue
            chans = " ".join(
                f"{n}[{r['dim']}]" for n, r in sorted(s["channels"].items()))
            print(f"{os.path.basename(path):<44} {s['backend']:<14} "
                  f"{s['samples']:>7}  {chans}")
    return 0


def cmd_check(spans: List[dict], dirpath: Optional[str] = None) -> int:
    problems: List[str] = []
    probe_files = _probe_files(dirpath)
    traces = spans_by_trace(spans)
    if not traces and not probe_files:
        problems.append("no spans found")
    if probe_files:
        from .timeseries import validate_series_file
        for path in probe_files:
            problems.extend(validate_series_file(path))
    for tid, recs in sorted(traces.items()):
        roots = _roots(recs)
        if not roots:
            problems.append(f"trace {tid}: no closed root span")
            continue
        by_parent = _children(recs)
        for root in roots:
            r0 = root.get("t_start") or 0.0
            r1 = root.get("t_end") or r0
            kids = by_parent.get(root.get("span_id"), [])
            for k in kids:
                k0 = k.get("t_start") or 0.0
                k1 = k.get("t_end") or k0
                if k0 < r0 - _EPS or k1 > r1 + _EPS:
                    problems.append(
                        f"trace {tid}: child {k.get('name')} outside "
                        f"root {root.get('name')} window")
            # sequential-execution invariants (non-overlap, walls summing
            # to <= the root wall) only bind children living in the
            # root's own process; cross-process children (fleet.run's
            # worker lifetimes) are concurrent by design
            seq = [k for k in kids if k.get("pid") == root.get("pid")]
            child_sum = 0.0
            prev_end = None
            for k in seq:
                k0 = k.get("t_start") or 0.0
                k1 = k.get("t_end") or k0
                child_sum += max(0.0, k1 - k0)
                if prev_end is not None and k0 < prev_end - _EPS:
                    problems.append(
                        f"trace {tid}: children of {root.get('name')} "
                        f"overlap at {k.get('name')}")
                prev_end = k1
            if child_sum > (r1 - r0) + _EPS * max(1, len(seq)):
                problems.append(
                    f"trace {tid}: children sum {child_sum * 1e3:.2f}ms "
                    f"> root {root.get('name')} wall "
                    f"{(r1 - r0) * 1e3:.2f}ms")
    if problems:
        print(f"obs check: {len(problems)} problem(s)")
        for p in problems:
            print(f"  FAIL {p}")
        return 1
    print(f"obs check: OK ({len(traces)} traces, "
          f"{sum(len(v) for v in traces.values())} spans"
          + (f", {len(probe_files)} probe series" if probe_files else "")
          + ")")
    return 0


def cmd_merge(paths: List[str], prom: bool) -> int:
    snaps = []
    for p in paths:
        with open(p, encoding="utf-8") as fh:
            loaded = json.load(fh)
        # accept either a bare snapshot or a report carrying one at "obs"
        if isinstance(loaded, dict) and "obs" in loaded \
                and isinstance(loaded.get("obs"), dict):
            loaded = loaded.get("obs")
        snaps.append(loaded)
    merged = merge_snapshots(snaps)
    if prom:
        sys.stdout.write(to_prometheus(merged))
    else:
        print(json.dumps(merged, indent=2, sort_keys=True))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.obs", description=__doc__)
    ap.add_argument("--dir", default=os.environ.get("REPRO_TRACE_DIR")
                    or "results/obs_trace",
                    help="span JSONL directory (default: $REPRO_TRACE_DIR)")
    ap.add_argument("--list", action="store_true", help="list traces")
    ap.add_argument("--trace", metavar="ID",
                    help="render one trace timeline (prefix ok)")
    ap.add_argument("--flame", action="store_true",
                    help="per-span-name flame summary")
    ap.add_argument("--check", action="store_true",
                    help="validate span structure; nonzero exit on problems")
    ap.add_argument("--merge", nargs="+", metavar="SNAP",
                    help="merge repro.obs/1 snapshot JSON files")
    ap.add_argument("--prom", action="store_true",
                    help="with --merge: print Prometheus text format")
    args = ap.parse_args(argv)

    if args.merge:
        return cmd_merge(args.merge, args.prom)

    spans = read_spans(args.dir)
    if args.trace:
        return cmd_trace(spans, args.trace)
    if args.flame:
        return cmd_flame(spans, args.dir)
    if args.check:
        return cmd_check(spans, args.dir)
    return cmd_list(spans)


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except BrokenPipeError:     # `... | head` closed the pipe; not an error
        raise SystemExit(0)
