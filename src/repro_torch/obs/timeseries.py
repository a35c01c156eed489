"""`repro.obs.timeseries/1` — probe time-series schema, JSONL, histograms.

The port's copy of `repro.obs.timeseries`; series written by either
package are read by the other. A probed simulation run
(`SimRequest(probes=ProbeConfig(...))`, or the core entry points'
`probes=` argument) returns a *series dict*:

    {"schema": "repro.obs.timeseries/1",
     "stride": 4, "max_samples": 256,
     "t":  (S,) float  sample times (nondecreasing),
     "ev": (S,) int    event indices (strictly increasing),
     "channels": {"link_queue": (S, L), "flow_remaining": (S, N), ...},
     "meta": {"backend": "m4", "units": {...}, ...}}

This module is the host-side half of the probes: JSONL persistence
(`write_series_jsonl`/`read_series_jsonl`, one header line + one line
per sample), structural validation (`validate_series`, run by
``python -m repro_torch.obs --check``), registry histograms
(`observe_series`), and the step-hold series distance the divergence
observatory (`repro_torch.obs.diff`) scores probed backends with.

The packet DES keeps no device arenas; `series_from_packet_trace`
synthesizes the same schema from its ground-truth event records (the
port's own `repro_torch.net.packetsim.Trace`), so m4's belief and the
oracle's truth compare channel for channel.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, Optional

import numpy as np

from ..core.probes import CHANNELS, ProbeConfig, SCHEMA_TS, normalize_probes
from .registry import MetricsRegistry, get_registry, labeled

__all__ = [
    "SCHEMA_TS", "validate_series", "validate_series_file",
    "write_series_jsonl", "read_series_jsonl", "series_from_packet_trace",
    "observe_series", "series_distance", "summarize_series",
]


# ------------------------------------------------------------- validation
def validate_series(series: Mapping) -> List[str]:
    """Structural invariants of one series dict; returns problem strings
    (empty = valid). This is what ``python -m repro_torch.obs --check``
    enforces on every probe JSONL file."""
    problems: List[str] = []
    if not isinstance(series, Mapping):
        return ["series is not a mapping"]
    if series.get("schema") != SCHEMA_TS:
        problems.append(f"bad schema {series.get('schema')!r} "
                        f"(expected {SCHEMA_TS!r})")
        return problems
    try:
        t = np.asarray(series["t"], np.float64)
        ev = np.asarray(series["ev"], np.int64)
    except Exception as e:                                  # noqa: BLE001
        return [f"unreadable t/ev arrays: {e}"]
    if t.ndim != 1 or ev.ndim != 1 or t.shape != ev.shape:
        problems.append(f"t/ev must be 1-d and equal length, "
                        f"got {t.shape} vs {ev.shape}")
        return problems
    if t.size and not np.isfinite(t).all():
        problems.append("non-finite sample times")
    if t.size > 1 and (np.diff(t) < 0).any():
        problems.append("sample times decrease")
    if ev.size > 1 and (np.diff(ev) <= 0).any():
        problems.append("event indices not strictly increasing")
    if int(series.get("stride") or 0) < 1:
        problems.append(f"bad stride {series.get('stride')!r}")
    chans = series.get("channels")
    if not isinstance(chans, Mapping) or not chans:
        problems.append("no channels recorded")
        return problems
    for name, arr in chans.items():
        if name not in CHANNELS:
            problems.append(f"unknown channel {name!r}")
            continue
        a = np.asarray(arr, np.float64)
        if a.ndim != 2 or a.shape[0] != t.size:
            problems.append(f"channel {name}: shape {a.shape} does not "
                            f"match {t.size} samples")
        elif a.size and not np.isfinite(a).all():
            problems.append(f"channel {name}: non-finite values")
    return problems


def validate_series_file(path: str) -> List[str]:
    """Validate one `.probes.jsonl` file; problems are prefixed with the
    file name so a directory sweep reads like a lint report."""
    try:
        series = read_series_jsonl(path)
    except Exception as e:                                  # noqa: BLE001
        return [f"{os.path.basename(path)}: unreadable: {e}"]
    return [f"{os.path.basename(path)}: {p}" for p in validate_series(series)]


# ------------------------------------------------------------------ JSONL
def write_series_jsonl(series: Mapping, path: str) -> str:
    """One header line (schema + channel dims + meta), then one line per
    sample — append-friendly and torn-tail tolerant like the span logs."""
    chans = {k: np.asarray(v, np.float64)
             for k, v in series["channels"].items()}
    t = np.asarray(series["t"], np.float64)
    ev = np.asarray(series["ev"], np.int64)
    header = {
        "schema": series["schema"],
        "stride": int(series.get("stride") or 1),
        "max_samples": int(series.get("max_samples") or t.size),
        "samples": int(t.size),
        "channels": {k: v.shape[1] for k, v in chans.items()},
        "meta": dict(series.get("meta") or {}),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(json.dumps(header) + "\n")
        for i, (ti, ei) in enumerate(zip(t, ev)):
            row = {"ev": int(ei), "t": float(ti)}
            for k, v in chans.items():
                row[k] = [float(x) for x in v[i]]
            fh.write(json.dumps(row) + "\n")
    os.replace(tmp, path)
    return path


def read_series_jsonl(path: str) -> dict:
    with open(path) as fh:
        lines = [ln for ln in fh.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty series file")
    header = json.loads(lines[0])
    rows = []
    for ln in lines[1:]:
        try:
            rows.append(json.loads(ln))
        except json.JSONDecodeError:
            break                          # torn trailing line: stop cleanly
    chan_dims = header.get("channels") or {}
    series = {
        "schema": header.get("schema"),
        "stride": header.get("stride", 1),
        "max_samples": header.get("max_samples", len(rows)),
        "t": np.array([r["t"] for r in rows], np.float64),
        "ev": np.array([r["ev"] for r in rows], np.int64),
        "channels": {
            k: (np.array([r[k] for r in rows], np.float64)
                if rows else np.zeros((0, d), np.float64))
            for k, d in chan_dims.items()},
        "meta": header.get("meta") or {},
    }
    return series


# -------------------------------------------------------- packet synthesis
def series_from_packet_trace(trace, probes: ProbeConfig,
                             num_flows: int) -> Optional[dict]:
    """Ground-truth series from the packet DES event records, honoring the
    same stride/ring semantics as the device probes. Supported channels:
    ``flow_remaining`` (exact residual bytes) and ``link_active`` (flows
    per path link) — the DES keeps no waterfill rates and its event
    records carry only per-path queue depths, not the full link vector."""
    probes = normalize_probes(probes, ("flow_remaining", "link_active"))
    if probes is None:
        return None
    recs = trace.events
    idx = list(range(0, len(recs), probes.stride))[-probes.max_samples:]
    L = trace.topo.num_links
    t = np.array([recs[i].time for i in idx], np.float64)
    ev = np.array(idx, np.int64)
    channels: Dict[str, np.ndarray] = {}
    if "flow_remaining" in probes.channels:
        rem = np.zeros((len(idx), num_flows), np.float64)
        for row, i in enumerate(idx):
            for fid, r in zip(recs[i].active, recs[i].remaining):
                rem[row, fid] = float(r)
        channels["flow_remaining"] = rem
    if "link_active" in probes.channels:
        act = np.zeros((len(idx), L), np.float64)
        paths = {f.fid: np.asarray(f.path, np.int64) for f in trace.flows}
        for row, i in enumerate(idx):
            for fid in recs[i].active:
                act[row, paths[fid]] += 1.0
        channels["link_active"] = act
    return {
        "schema": SCHEMA_TS,
        "stride": probes.stride,
        "max_samples": probes.max_samples,
        "t": t,
        "ev": ev,
        "channels": channels,
        "meta": {"backend": "packet",
                 "units": {"flow_remaining": "bytes", "link_active": "flows"}},
    }


# -------------------------------------------------------------- histograms
def observe_series(series: Mapping, registry: MetricsRegistry = None,
                   prefix: str = "probe", **labels) -> None:
    """Stream every finite channel value into registry histograms
    (``probe.<channel>{...}``) — so probe distributions merge across
    processes exactly like every other registry histogram."""
    reg = registry or get_registry()
    backend = (series.get("meta") or {}).get("backend")
    if backend and "backend" not in labels:
        labels["backend"] = backend
    units = (series.get("meta") or {}).get("units") or {}
    for name, arr in (series.get("channels") or {}).items():
        a = np.asarray(arr, np.float64).ravel()
        a = a[np.isfinite(a)]
        metric = labeled(f"{prefix}.{name}", **labels)
        h = reg.histogram(
            metric, desc=f"probe channel {name}"
                         + (f" ({units[name]})" if name in units else ""))
        for v in a:
            h.observe(float(v))


# ---------------------------------------------------------------- distance
def _step_resample(t: np.ndarray, values: np.ndarray,
                   grid: np.ndarray) -> np.ndarray:
    """Previous-sample-hold resampling of (S, D) values onto `grid`."""
    idx = np.clip(np.searchsorted(t, grid, side="right") - 1, 0, len(t) - 1)
    return values[idx]


def series_distance(a: Mapping, b: Mapping,
                    channels=None) -> Dict[str, float]:
    """Normalized L1 distance per shared channel, with `b` as reference.

    Both series are step-hold resampled onto the union of their sample
    times (flow-level state is piecewise constant between events), then
    ``mean|A - B| / (mean|B| + eps)`` — 0.0 means identical beliefs, 1.0
    means the error is as large as the reference signal itself. Channels
    whose entity dimension disagrees (different flow/link counts) are
    skipped: distance is only defined over the same scenario."""
    out: Dict[str, float] = {}
    shared = set(a.get("channels") or {}) & set(b.get("channels") or {})
    if channels is not None:
        shared &= set(channels)
    ta = np.asarray(a["t"], np.float64)
    tb = np.asarray(b["t"], np.float64)
    if ta.size == 0 or tb.size == 0:
        return out
    grid = np.union1d(ta, tb)
    for ch in sorted(shared):
        A = np.asarray(a["channels"][ch], np.float64)
        B = np.asarray(b["channels"][ch], np.float64)
        if A.ndim != 2 or B.ndim != 2 or A.shape[1] != B.shape[1]:
            continue
        Ag = _step_resample(ta, A, grid)
        Bg = _step_resample(tb, B, grid)
        ref = float(np.mean(np.abs(Bg)))
        out[ch] = float(np.mean(np.abs(Ag - Bg)) / (ref + 1e-12))
    return out


# ----------------------------------------------------------------- summary
def summarize_series(series: Mapping) -> dict:
    """Per-channel summary row (used by the ``--flame`` probe table)."""
    t = np.asarray(series["t"], np.float64)
    rows = {}
    for name, arr in (series.get("channels") or {}).items():
        a = np.asarray(arr, np.float64)
        rows[name] = {
            "dim": a.shape[1] if a.ndim == 2 else 0,
            "mean": float(a.mean()) if a.size else 0.0,
            "max": float(a.max()) if a.size else 0.0,
        }
    t0, t1 = (t[0], t[-1]) if t.size else (0.0, 0.0)
    return {
        "samples": int(t.size),
        "t0": float(t0),
        "t1": float(t1),
        "backend": (series.get("meta") or {}).get("backend", "?"),
        "channels": rows,
    }
