"""repro_torch.obs — the port's telemetry: metrics registry, trace spans,
PyTorch profiling hooks, probe time series, and exporters, shared by the
sweep runner, the training loop and the backends.

The port of `repro.obs`, with `jaxprof` as `torchprof`. Snapshots, span
files and series files are the JAX package's formats, so either
package's tools read the other's.

`repro_torch.obs.diff` (the m4-vs-oracle divergence observatory) is *not*
imported here: it reaches into `repro_torch.scenarios` at call time, and
an eager import would tangle the obs <- sim <- scenarios layering. Import
it as ``from repro_torch.obs import diff`` /
``python -m repro_torch.obs.diff``."""

from .registry import (
    SCHEMA,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    hist_quantiles,
    labeled,
    merge_snapshots,
    split_labels,
)
from .trace import (
    NULL_SPAN,
    Span,
    Tracer,
    configure,
    get_tracer,
    new_id,
    read_spans,
    spans_by_trace,
    task_trace_id,
)
from .torchprof import PhaseStats, live_array_bytes, phase
from .export import lookup, parse_prometheus, to_prometheus
from .timeseries import (
    SCHEMA_TS,
    observe_series,
    read_series_jsonl,
    series_distance,
    series_from_packet_trace,
    summarize_series,
    validate_series,
    validate_series_file,
    write_series_jsonl,
)

__all__ = [
    "SCHEMA", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "hist_quantiles", "labeled", "merge_snapshots",
    "split_labels",
    "NULL_SPAN", "Span", "Tracer", "configure", "get_tracer", "new_id",
    "read_spans", "spans_by_trace", "task_trace_id",
    "PhaseStats", "live_array_bytes", "phase",
    "lookup", "parse_prometheus", "to_prometheus",
    "SCHEMA_TS", "observe_series", "read_series_jsonl", "series_distance",
    "series_from_packet_trace", "summarize_series", "validate_series",
    "validate_series_file", "write_series_jsonl",
]
