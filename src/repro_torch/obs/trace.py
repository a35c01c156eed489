"""Structured trace spans over append-only JSONL files.

The port's copy of `repro.obs.trace`: the same record layout, file names
and environment variables, so `python -m repro.obs --check` reads the
port's span files and `python -m repro_torch.obs --check` the JAX
package's.

A :class:`Tracer` writes one JSON line per *finished* span to
``<dir>/spans-<proc>-<pid>.jsonl`` (append-only, atomic at the line
level; readers skip torn trailing lines). Nothing is written for spans
that never close, so a process killed mid-span leaves no root span.

``REPRO_TRACE_DIR`` switches tracing on in child processes (they inherit
``os.environ``); ``REPRO_TRACE_PARENT`` = ``"<trace_id>:<span_id>"``
makes the child's top-level spans children of a parent-process span.
:func:`task_trace_id` gives a fleet task (`repro_torch.fleet`, as the
JAX package's fleet does) its deterministic trace id, so every retry of
a task shares one trace.

A span pushed on the thread's stack (`Tracer.span`, and so
`torchprof.phase`) has a second sink: while `torch.profiler` records,
it also opens a `torch.profiler.record_function` range of the same name
on the same thread, closed when the span ends. The profiler's host
clock is the epoch's, as `time.time()` is, so those ranges and the JSONL
records share one clock with the profiler's device trace. Spans made by
`Tracer.start` and `emit_span` cross threads and stay JSONL-only: a
profiler range must close on the thread that opened it. No span waits
for the device; a span times the host, and a wait for the device shows
in the span that copies results back.

Tracing is opt-in. With no trace dir configured and the profiler not
recording, the tracer hands out a shared no-op span: no I/O, no id
generation and no timestamping.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
import time
import uuid
from typing import Dict, List, Optional

TRACE_DIR_ENV = "REPRO_TRACE_DIR"
TRACE_PARENT_ENV = "REPRO_TRACE_PARENT"


def new_id() -> str:
    return uuid.uuid4().hex[:16]


def task_trace_id(task_id: str) -> str:
    """Deterministic trace id for a fleet task: retries share a trace."""
    return hashlib.sha256(task_id.encode()).hexdigest()[:16]


def profiling() -> bool:
    """Whether `torch.profiler` is recording; False when torch was never
    imported (this module does not import it)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


class Span:
    """A live span; written out as one JSONL record when ended."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id",
        "t_start", "t_end", "attrs", "status", "_tracer", "_pop",
        "_range",
    )

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: Optional[str],
                 attrs: Optional[dict] = None) -> None:
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t_start = time.time()
        self.t_end: Optional[float] = None
        self.attrs: Dict[str, object] = dict(attrs or {})
        self.status = "ok"
        self._pop = False
        self._range = None       # the profiler's range, while recording

    def attr(self, key: str, value: object) -> "Span":
        self.attrs[key] = value
        return self

    def end(self, status: Optional[str] = None, **attrs: object) -> None:
        if self.t_end is not None:  # idempotent
            return
        self.t_end = time.time()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if status is not None:
            self.status = status
        if attrs:
            self.attrs.update(attrs)
        if self._pop:
            self._tracer._pop_span(self)
        if self._tracer.enabled:
            self._tracer._emit(self._record())

    def _record(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "t_start": self.t_start,
            "t_end": self.t_end,
            "status": self.status,
            "proc": self._tracer.proc,
            "pid": os.getpid(),
            "attrs": self.attrs,
        }

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None and self.t_end is None:
            self.end(status=f"error:{exc_type.__name__}")
        else:
            self.end()


class _NullSpan:
    """Shared no-op span: tracing off costs two flag checks."""

    __slots__ = ()
    name = ""
    trace_id = ""
    span_id = ""
    parent_id = None
    t_start = 0.0
    t_end = 0.0
    status = "ok"
    attrs: Dict[str, object] = {}

    def attr(self, key, value):
        return self

    def end(self, status=None, **attrs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    """Span factory bound to one output directory (or disabled)."""

    def __init__(self, directory: Optional[str] = None,
                 proc: str = "main") -> None:
        self.dir = directory
        self.proc = proc
        self._local = threading.local()
        self._io_lock = threading.Lock()
        self._fh = None
        parent = os.environ.get(TRACE_PARENT_ENV, "")
        self.default_parent: Optional[tuple] = None
        if ":" in parent:
            tid, _, sid = parent.partition(":")
            if tid and sid:
                self.default_parent = (tid, sid)

    @property
    def enabled(self) -> bool:
        """Whether spans are written to JSONL files."""
        return self.dir is not None

    # -- span creation ---------------------------------------------------
    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    def start(self, name: str, parent: Optional[Span] = None,
              trace_id: Optional[str] = None,
              span_id: Optional[str] = None,
              attrs: Optional[dict] = None):
        """Create a span without pushing it on the thread's stack.

        Use for spans handed across threads (e.g. a pending serve
        request whose lifecycle continues on the dispatcher thread).
        """
        if not self.enabled:
            return NULL_SPAN
        return self._make(name, parent, trace_id, span_id, attrs)

    def span(self, name: str, parent: Optional[Span] = None,
             trace_id: Optional[str] = None,
             span_id: Optional[str] = None,
             attrs: Optional[dict] = None):
        """Create a span and push it on the thread-local stack, so
        spans opened inside it become its children.  Use as a context
        manager, ended on the thread that opened it. While
        `torch.profiler` records, the span is also a `record_function`
        range of its name; with neither sink on it is `NULL_SPAN`."""
        prof = profiling()
        if self.dir is None and not prof:
            return NULL_SPAN
        sp = self._make(name, parent, trace_id, span_id, attrs)
        sp._pop = True
        if prof:
            sp._range = sys.modules["torch"].profiler.record_function(name)
            sp.t_start = time.time()    # the range starts early in enter
            sp._range.__enter__()
        self._stack().append(sp)
        return sp

    def _make(self, name, parent, trace_id, span_id, attrs) -> Span:
        if trace_id is not None:
            # explicit trace id means "root of that trace" unless a
            # parent is also given
            p_trace, p_span = trace_id, None
            if parent is not None and parent is not NULL_SPAN:
                p_span = parent.span_id
        elif parent is not None and parent is not NULL_SPAN:
            p_trace, p_span = parent.trace_id, parent.span_id
        else:
            cur = self.current()
            if cur is not None:
                p_trace, p_span = cur.trace_id, cur.span_id
            elif self.default_parent is not None:
                p_trace, p_span = self.default_parent
            else:
                p_trace, p_span = new_id(), None
        return Span(self, name, p_trace, span_id or new_id(), p_span, attrs)

    def _pop_span(self, sp: Span) -> None:
        st = self._stack()
        if sp in st:
            st.remove(sp)

    def emit_span(self, name: str, parent, t_start: float, t_end: float,
                  attrs: Optional[dict] = None, status: str = "ok") -> None:
        """Write an already-timed span (explicit wall-clock window)."""
        if not self.enabled or parent is NULL_SPAN or parent is None:
            return
        self._emit({
            "trace_id": parent.trace_id,
            "span_id": new_id(),
            "parent_id": parent.span_id,
            "name": name,
            "t_start": t_start,
            "t_end": t_end,
            "status": status,
            "proc": self.proc,
            "pid": os.getpid(),
            "attrs": dict(attrs or {}),
        })

    # -- output ----------------------------------------------------------
    def _emit(self, record: dict) -> None:
        if self.dir is None:
            return
        with self._io_lock:
            if self._fh is None:
                os.makedirs(self.dir, exist_ok=True)
                safe = "".join(c if c.isalnum() or c in "-_" else "-"
                               for c in self.proc)
                path = os.path.join(
                    self.dir, f"spans-{safe}-{os.getpid()}.jsonl")
                self._fh = open(path, "a", encoding="utf-8")
            self._fh.write(json.dumps(record, sort_keys=True) + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._io_lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


_GLOBAL: Optional[Tracer] = None
_GLOBAL_LOCK = threading.Lock()


def get_tracer() -> Tracer:
    """Process-global tracer, configured from ``REPRO_TRACE_DIR`` on
    first use (spawn children inherit the env and trace themselves)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = Tracer(os.environ.get(TRACE_DIR_ENV) or None)
        return _GLOBAL


def configure(directory: Optional[str], proc: str = "main") -> Tracer:
    """Replace the global tracer; also exports ``REPRO_TRACE_DIR`` so
    children spawned after this call trace into the same directory."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is not None:
            _GLOBAL.close()
        _GLOBAL = Tracer(directory, proc=proc)
        if directory:
            os.environ[TRACE_DIR_ENV] = directory
        return _GLOBAL


# -- reading -------------------------------------------------------------

def read_spans(directory: str) -> List[dict]:
    """Load every span record under ``directory``; torn/partial lines
    (from killed writers) are skipped, not fatal."""
    out: List[dict] = []
    if not os.path.isdir(directory):
        return out
    for fname in sorted(os.listdir(directory)):
        if not (fname.startswith("spans-") and fname.endswith(".jsonl")):
            continue
        with open(os.path.join(directory, fname), encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict) and rec.get("trace_id"):
                    out.append(rec)
    return out


def spans_by_trace(spans: List[dict]) -> Dict[str, List[dict]]:
    out: Dict[str, List[dict]] = {}
    for rec in spans:
        out.setdefault(rec["trace_id"], []).append(rec)
    for recs in out.values():
        recs.sort(key=lambda r: (r.get("t_start") or 0.0, r.get("span_id")))
    return out
