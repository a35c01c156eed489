"""repro_torch.obs.diff — the divergence observatory: *where* is m4 wrong?

The port of `repro.obs.diff`. For every scenario of a suite it runs a
learned backend and a ground-truth oracle through the same `SweepRunner`
(FCT passes are cache-eligible, so a re-run against an already-simulated
packet oracle is pure cache hits) and computes a *divergence profile*:
per-flow relative FCT error (mean + p90), slowdown percentile deltas
(p50/p90/p99), and — when both sides carry probes — the step-hold
`series_distance` between their intermediate-state beliefs
(`repro_torch.obs.timeseries`).

Profiles are then grouped two ways: by scenario *family* (workload x
size distribution x CC scheme — the axes of the paper's Table 2) and by
greedy signature clustering (scenarios that diverge *the same way* land
in one cluster even across families). The ranked report (schema
``repro.obs.diff/1``, the JAX package's) round-trips through JSON and
re-materializes its worst scenarios as a suite (`worst_suite`; the
scenarios registry's ``divergence_worst`` reads the same file), so
training can oversample exactly where the model is wrong. The JAX
package's fleet side (`divergence_from_coord`, `SweepJob.diff_against`)
waits for the port's fleet.

CLI (m4 and flowsim_fast on the card unless ``--device cpu``)::

    python -m repro_torch.obs.diff --suite smoke16 --limit 4 --num-flows 16 \
        --probes --out results/divergence/report.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from .registry import MetricsRegistry, labeled
from .timeseries import series_distance, write_series_jsonl

SCHEMA_DIFF = "repro.obs.diff/1"
_PCTS = (50, 90, 99)

__all__ = [
    "SCHEMA_DIFF", "DivergenceProfile", "flow_rel_err", "profile_scenario",
    "rank_families", "cluster_profiles", "diff_sweep", "build_report",
    "write_report", "read_report", "worst_suite", "main",
]


# ---------------------------------------------------------------- profiles
@dataclasses.dataclass
class DivergenceProfile:
    """One scenario's m4-vs-oracle divergence signature."""
    label: str
    family: str                     # workload/size_dist/cc grouping key
    num_flows: int
    mean_rel_err: float             # mean per-flow |fct - fct*| / fct*
    p90_rel_err: float
    sldn_delta: Dict[str, float]    # {"p50": ..., "p90": ..., "p99": ...}
    probe_distance: Dict[str, float]  # per shared channel; {} when unprobed
    score: float                    # ranking key (== mean_rel_err)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def flow_rel_err(fcts, oracle_fcts) -> np.ndarray:
    """Per-flow relative FCT error against the oracle, NaN-flows dropped
    pairwise (a flow unfinished on either side carries no error signal)."""
    a = np.asarray(fcts, np.float64)
    b = np.asarray(oracle_fcts, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"flow count mismatch: {a.shape} vs {b.shape} "
                         "(divergence is only defined over one scenario)")
    ok = np.isfinite(a) & np.isfinite(b)
    a, b = a[ok], b[ok]
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-12)


def _family(spec) -> str:
    return f"{spec.workload}/{spec.size_dist}/{spec.cc}"


def profile_scenario(spec, result, oracle_result,
                     series=None, oracle_series=None):
    """(DivergenceProfile, per-flow error vector) for one scenario."""
    err = flow_rel_err(result.fcts, oracle_result.fcts)
    sldn_delta = {}
    sa = np.asarray(result.slowdowns, np.float64)
    sb = np.asarray(oracle_result.slowdowns, np.float64)
    for p in _PCTS:
        sldn_delta[f"p{p}"] = float(np.nanpercentile(sa, p)
                                    - np.nanpercentile(sb, p))
    dist: Dict[str, float] = {}
    if series is not None and oracle_series is not None:
        dist = series_distance(series, oracle_series)
    mean_err = float(err.mean()) if err.size else 0.0
    prof = DivergenceProfile(
        label=spec.label, family=_family(spec), num_flows=len(result.fcts),
        mean_rel_err=mean_err,
        p90_rel_err=float(np.percentile(err, 90)) if err.size else 0.0,
        sldn_delta=sldn_delta, probe_distance=dist, score=mean_err)
    return prof, err


# ---------------------------------------------------- families + clusters
def rank_families(profiles: Sequence[DivergenceProfile]) -> List[dict]:
    """Group profiles by Table-2 family and rank by mean divergence."""
    fams: Dict[str, List[DivergenceProfile]] = {}
    for p in profiles:
        fams.setdefault(p.family, []).append(p)
    rows = []
    for fam, ps in fams.items():
        worst = max(ps, key=lambda p: p.score)
        rows.append({
            "family": fam, "scenarios": len(ps),
            "mean_rel_err": float(np.mean([p.mean_rel_err for p in ps])),
            "max_rel_err": worst.mean_rel_err,
            "worst_scenario": worst.label,
        })
    rows.sort(key=lambda r: -r["mean_rel_err"])
    return rows


def _signature(p: DivergenceProfile) -> List[float]:
    return [p.mean_rel_err, p.p90_rel_err,
            *(abs(p.sldn_delta.get(f"p{q}", 0.0)) for q in _PCTS)]


def cluster_profiles(profiles: Sequence[DivergenceProfile],
                     threshold: float = 0.35) -> List[dict]:
    """Greedy signature clustering (SDNRacer-style equivalence grouping,
    no sklearn): normalize each signature axis to [0, 1], walk profiles
    worst-first, join the nearest cluster centroid within `threshold` or
    open a new cluster. Scenarios that diverge the *same way* cluster
    together even when their Table-2 families differ."""
    if not profiles:
        return []
    sigs = np.array([_signature(p) for p in profiles], np.float64)
    scale = np.maximum(sigs.max(axis=0), 1e-12)
    norm = sigs / scale
    order = sorted(range(len(profiles)), key=lambda i: -profiles[i].score)
    centroids: List[np.ndarray] = []
    members: List[List[int]] = []
    for i in order:
        row = norm[i]
        if centroids:
            d = [float(np.linalg.norm(row - c)) for c in centroids]
            j = int(np.argmin(d))
            if d[j] <= threshold:
                members[j].append(i)
                centroids[j] = np.mean(norm[members[j]], axis=0)
                continue
        centroids.append(row.copy())
        members.append([i])
    out = []
    for c, idxs in zip(centroids, members):
        errs = [profiles[i].mean_rel_err for i in idxs]
        out.append({
            "size": len(idxs),
            "scenarios": [profiles[i].label for i in idxs],
            "mean_rel_err": float(np.mean(errs)),
            "signature": [round(float(v), 6) for v in c * scale],
        })
    out.sort(key=lambda r: -r["mean_rel_err"])
    return out


# ------------------------------------------------------------------ report
def build_report(suite_name: str, backend_name: str, oracle_name: str,
                 specs: Sequence, profiles: Sequence[DivergenceProfile],
                 errors: Sequence[np.ndarray], k_worst: int = 8) -> dict:
    """Assemble the ranked ``repro.obs.diff/1`` report. `specs`, `profiles`
    and `errors` align; the pooled summary weights every *flow* equally
    (a 200-flow scenario counts 200x a 2-flow one)."""
    from ..scenarios.spec import spec_to_dict
    order = sorted(range(len(profiles)), key=lambda i: -profiles[i].score)
    pooled = np.concatenate([np.asarray(e, np.float64) for e in errors]) \
        if errors else np.zeros(0, np.float64)
    summary = {
        "scenarios": len(profiles),
        "flows": int(pooled.size),
        "mean_rel_err": round(float(pooled.mean()), 6) if pooled.size else 0.0,
        "p90_rel_err": round(float(np.percentile(pooled, 90)), 6)
        if pooled.size else 0.0,
        "worst_scenario": profiles[order[0]].label if order else "",
    }
    return {
        "schema": SCHEMA_DIFF,
        "suite": suite_name, "backend": backend_name, "oracle": oracle_name,
        "summary": summary,
        "profiles": [profiles[i].as_dict() for i in order],
        "families": rank_families(profiles),
        "clusters": cluster_profiles(profiles),
        "worst_specs": [spec_to_dict(specs[i]) for i in order[:k_worst]],
    }


def write_report(report: Mapping, path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return path


def read_report(path: str) -> dict:
    with open(path) as fh:
        report = json.load(fh)
    if report.get("schema") != SCHEMA_DIFF:
        raise ValueError(f"{path}: not a {SCHEMA_DIFF} report "
                         f"(schema={report.get('schema')!r})")
    return report


def worst_suite(report: Mapping, k: Optional[int] = None,
                num_flows: Optional[int] = None):
    """Re-materialize the report's worst scenarios as a Sweep — the suite
    training oversamples to fix what the model gets wrong."""
    from ..scenarios.spec import Sweep, spec_from_dict
    specs = [spec_from_dict(d) for d in report.get("worst_specs", [])]
    if k is not None:
        specs = specs[:k]
    if num_flows:
        specs = [dataclasses.replace(s, num_flows=num_flows) for s in specs]
    return Sweep("divergence_worst", tuple(specs))


# ------------------------------------------------------------------- sweep
def diff_sweep(suite, backend, oracle, *, cache_dir: Optional[str] = None,
               chunk_size: Optional[int] = 8, probes=None,
               probes_dir: Optional[str] = None,
               registry: Optional[MetricsRegistry] = None,
               k_worst: int = 8) -> dict:
    """Run `suite` through both backends and return the divergence report.

    FCT metrics come from unprobed passes (cache-eligible: a re-run
    against an already-simulated packet oracle is pure hits); when
    `probes` is a ProbeConfig, separate probed passes capture both sides'
    intermediate-state series for the `probe_distance` channel distances
    (probed results bypass the cache by design — see SweepRunner.run).
    `probes_dir` additionally persists every captured series as
    ``<scenario>.<backend>.probes.jsonl`` (what
    ``python -m repro_torch.obs --check`` validates).
    """
    from ..scenarios.runner import SweepRunner
    specs = list(suite)
    name = getattr(suite, "name", "sweep")
    rep_b = SweepRunner(backend, cache_dir=cache_dir,
                        chunk_size=chunk_size).run(suite)
    rep_o = SweepRunner(oracle, cache_dir=cache_dir,
                        chunk_size=chunk_size).run(suite)
    series_b: List[Optional[dict]] = [None] * len(specs)
    series_o: List[Optional[dict]] = [None] * len(specs)
    if probes is not None:
        pb = SweepRunner(backend, cache_dir=None,
                         chunk_size=chunk_size).run(suite, probes=probes)
        po = SweepRunner(oracle, cache_dir=None,
                         chunk_size=chunk_size).run(suite, probes=probes)
        series_b = [e.result.probes if e.result is not None else None
                    for e in pb.entries]
        series_o = [e.result.probes if e.result is not None else None
                    for e in po.entries]
        if probes_dir:
            for spec, sb, so in zip(specs, series_b, series_o):
                tag = re.sub(r"[^A-Za-z0-9._-]", "_", spec.label)
                for s, who in ((sb, backend.name), (so, oracle.name)):
                    if s is not None:
                        write_series_jsonl(s, os.path.join(
                            probes_dir, f"{tag}.{who}.probes.jsonl"))

    profiles: List[DivergenceProfile] = []
    errors: List[np.ndarray] = []
    kept_specs: List = []
    reg = registry or MetricsRegistry(proc="obs.diff")
    h_err = reg.histogram(
        labeled("diff.rel_err", backend=backend.name, oracle=oracle.name),
        desc="per-flow relative FCT error vs the oracle backend")
    for i, (eb, eo) in enumerate(zip(rep_b.entries, rep_o.entries)):
        if eb.result is None or eo.result is None:
            continue
        prof, err = profile_scenario(specs[i], eb.result, eo.result,
                                     series_b[i], series_o[i])
        profiles.append(prof)
        errors.append(err)
        kept_specs.append(specs[i])
        for v in err:
            h_err.observe(float(v))
        for ch, d in prof.probe_distance.items():
            reg.histogram(
                labeled("diff.probe_distance", channel=ch,
                        backend=backend.name, oracle=oracle.name),
                desc="normalized L1 distance between probe series "
                     "(repro.obs.timeseries)").observe(d)
    report = build_report(name, backend.name, oracle.name, kept_specs,
                          profiles, errors, k_worst=k_worst)
    reg.set_gauge(labeled("diff.mean_rel_err", backend=backend.name,
                          oracle=oracle.name),
                  report["summary"]["mean_rel_err"])
    reg.describe("diff.mean_rel_err",
                 "flow-pooled mean relative FCT error vs the oracle")
    report["obs"] = reg.snapshot()
    return report


# --------------------------------------------------------------------- CLI
def _build_backend(name: str, device: str = "cuda"):
    """m4 gets a deterministic gate-scale model (the JAX package's
    construction in `repro.obs.diff`, h16/g16/m16/l2/SF16/SL32) from the
    port's `init_m4(0, cfg)`: seeded torch weights, not the JAX package's
    `PRNGKey(0)` weights, so the two CLIs' m4 reports differ (the parity
    tests bridge JAX's weights in instead). flowsim_fast runs on `device`
    too; the host backends take none."""
    from ..sim import get_backend
    if name == "m4":
        from ..core.model import M4Config, init_m4
        cfg = M4Config(hidden=16, gnn_dim=16, mlp_hidden=16, gnn_layers=2,
                       snap_flows=16, snap_links=32)
        return get_backend("m4", params=init_m4(0, cfg), cfg=cfg,
                           device=device)
    if name == "flowsim_fast":
        return get_backend(name, device=device)
    return get_backend(name)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.obs.diff",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--suite", default="smoke16",
                    help="scenario suite name (repro_torch.scenarios)")
    ap.add_argument("--limit", type=int, default=0,
                    help="first N scenarios only (0 = all)")
    ap.add_argument("--num-flows", type=int, default=24,
                    help="flows per scenario (forwarded to the suite)")
    ap.add_argument("--backend", default="m4",
                    help="learned/approximate side (default m4, gate-scale "
                         "deterministic weights)")
    ap.add_argument("--oracle", default="packet",
                    help="ground-truth side (default packet)")
    ap.add_argument("--cache-dir", default="results/sweep_cache",
                    help="result cache for the FCT passes ('' disables)")
    ap.add_argument("--out", default="results/divergence/report.json")
    ap.add_argument("--probes", action="store_true",
                    help="also capture probe series on both sides and "
                         "score their distance")
    ap.add_argument("--stride", type=int, default=4,
                    help="probe sample stride (with --probes)")
    ap.add_argument("--max-samples", type=int, default=64,
                    help="probe ring-buffer depth (with --probes)")
    ap.add_argument("--worst", type=int, default=8,
                    help="how many worst specs to embed in the report")
    ap.add_argument("--device", default="cuda",
                    help="device of m4 and flowsim_fast (default cuda; "
                         "'cpu' runs the plain versions of the kernels)")
    args = ap.parse_args(argv)

    from ..scenarios.suites import get_suite
    suite = get_suite(args.suite, num_flows=args.num_flows)
    if args.limit:
        suite = suite.limit(args.limit)
    probes = None
    if args.probes:
        from ..core.probes import ProbeConfig
        probes = ProbeConfig(stride=args.stride, max_samples=args.max_samples)
    report = diff_sweep(
        suite, _build_backend(args.backend, args.device),
        _build_backend(args.oracle, args.device),
        cache_dir=args.cache_dir or None, probes=probes,
        probes_dir=os.path.dirname(os.path.abspath(args.out))
        if args.probes else None,
        k_worst=args.worst)
    path = write_report(report, args.out)
    s = report["summary"]
    print(f"divergence: {s['scenarios']} scenarios, {s['flows']} flows — "
          f"mean rel err {s['mean_rel_err']:.4f}, "
          f"p90 {s['p90_rel_err']:.4f}, worst {s['worst_scenario']!r}")
    for fam in report["families"][:5]:
        print(f"  family {fam['family']:<32} mean={fam['mean_rel_err']:.4f} "
              f"({fam['scenarios']} scenarios, worst "
              f"{fam['worst_scenario']!r})")
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
