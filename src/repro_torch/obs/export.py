"""Exporters: Prometheus text exposition format + a strict parser.

The port's copy of `repro.obs.export`: the same text for the same
snapshot, byte for byte.

The writer turns a ``repro.obs/1`` snapshot into Prometheus text format
(version 0.0.4): counters become ``<name>_total``, gauges pass through,
histograms render as summaries (``quantile`` labels + ``_sum`` +
``_count``).  Dotted metric names map to underscores; the registry's
``name{k="v"}`` label-suffix convention becomes real Prometheus labels.

The parser is deliberately strict — it exists so tests can *round-trip*
``GET /metrics`` and fail loudly on malformed output rather than on a
scrape 500 three services later.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Optional, Tuple

from .registry import Histogram, split_labels

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(?:\{([^{}]*)\})?"                     # optional label body
    r" (NaN|[+-]Inf|[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"\\]*)"')
_HEAD_RE = re.compile(r"^# (HELP|TYPE) ([a-zA-Z_:][a-zA-Z0-9_:]*)(?: (.*))?$")
_TYPES = {"counter", "gauge", "summary", "histogram", "untyped"}


def sanitize(name: str) -> str:
    out = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    if not out or not re.match(r"[a-zA-Z_:]", out[0]):
        out = "_" + out
    return out


def _fmt(v: float) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    f = v * 1.0
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_text(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    body = ",".join(f'{sanitize(k)}="{labels[k]}"' for k in sorted(labels))
    return "{" + body + "}"


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _unescape_help(text: str) -> str:
    return text.replace("\\n", "\n").replace("\\\\", "\\")


def to_prometheus(snapshot: Mapping, prefix: str = "repro",
                  extra_labels: Optional[Mapping[str, str]] = None) -> str:
    """Render a ``repro.obs/1`` snapshot as Prometheus text format.

    Metric descriptions recorded via ``MetricsRegistry.describe`` (the
    snapshot's ``descriptions`` map, keyed by label-free base name) become
    the ``# HELP`` text; undescribed metrics keep the generic help line.
    """
    lines = []
    seen_heads = set()
    descs = snapshot.get("descriptions") or {}

    def head(name: str, mtype: str, base: str) -> None:
        if name in seen_heads:
            return
        seen_heads.add(name)
        help_text = _escape_help(descs.get(base) or "repro.obs metric")
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")

    def full_labels(suffix_labels: Mapping[str, str]) -> Dict[str, str]:
        merged = dict(extra_labels or {})
        merged.update(suffix_labels)
        return merged

    for raw, v in (snapshot.get("counters") or {}).items():
        base, labels = split_labels(raw)
        name = f"{prefix}_{sanitize(base)}_total"
        head(name, "counter", base)
        lines.append(f"{name}{_labels_text(full_labels(labels))} {_fmt(v)}")

    for raw, v in (snapshot.get("gauges") or {}).items():
        base, labels = split_labels(raw)
        name = f"{prefix}_{sanitize(base)}"
        head(name, "gauge", base)
        lines.append(f"{name}{_labels_text(full_labels(labels))} {_fmt(v)}")

    for raw, d in (snapshot.get("histograms") or {}).items():
        base, labels = split_labels(raw)
        name = f"{prefix}_{sanitize(base)}"
        head(name, "summary", base)
        h = Histogram.from_dict(d, raw)
        merged = full_labels(labels)
        for q in (0.5, 0.99, 0.999):
            ql = dict(merged)
            ql["quantile"] = str(q)
            lines.append(f"{name}{_labels_text(ql)} {_fmt(h.quantile(q))}")
        lt = _labels_text(merged)
        lines.append(f"{name}_sum{lt} {_fmt(h.sum)}")
        lines.append(f"{name}_count{lt} {_fmt(h.count)}")

    return "\n".join(lines) + "\n"


def parse_prometheus(text: str, meta: bool = False):
    """Strictly parse Prometheus text format.

    Returns ``{(name, frozenset(label_items)): value}``.  Raises
    ``ValueError`` naming the offending line on any malformed input:
    bad metric names, unparseable label bodies, unknown TYPE values,
    trailing garbage.

    ``meta=True`` additionally returns the ``# HELP``/``# TYPE`` header
    metadata as a second value — ``{prom_name: {"help": ..., "type": ...}}``
    — so exported descriptions round-trip through the parser.
    """
    out: Dict[Tuple[str, frozenset], float] = {}
    heads: Dict[str, Dict[str, str]] = {}
    for lineno, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("#"):
            m = _HEAD_RE.match(line)
            if m is None:
                raise ValueError(f"line {lineno}: malformed comment: {line!r}")
            if m.group(1) == "TYPE" and (m.group(3) or "") not in _TYPES:
                raise ValueError(
                    f"line {lineno}: unknown TYPE {m.group(3)!r}")
            entry = heads.setdefault(m.group(2), {})
            if m.group(1) == "HELP":
                entry["help"] = _unescape_help(m.group(3) or "")
            else:
                entry["type"] = m.group(3) or ""
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        name, label_body, value = m.group(1), m.group(2), m.group(3)
        labels: Dict[str, str] = {}
        if label_body:
            rest = label_body
            while rest:
                lm = _LABEL_RE.match(rest)
                if lm is None:
                    raise ValueError(
                        f"line {lineno}: malformed labels: {label_body!r}")
                labels[lm.group(1)] = lm.group(2)
                rest = rest[lm.end():]
                if rest.startswith(","):
                    rest = rest[1:]
                elif rest:
                    raise ValueError(
                        f"line {lineno}: malformed labels: {label_body!r}")
        key = (name, frozenset(labels.items()))
        if key in out:
            raise ValueError(f"line {lineno}: duplicate sample {name!r}")
        out[key] = float(value)
    return (out, heads) if meta else out


def lookup(parsed: Mapping, name: str, **labels: str) -> Optional[float]:
    """Fetch one sample from :func:`parse_prometheus` output."""
    return parsed.get((name, frozenset(labels.items())))
