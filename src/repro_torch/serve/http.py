"""Stdlib HTTP front-end + client for out-of-process callers (the port
of `repro.serve.http`).

The wire format is the JAX package's, byte for byte, so either package's
`ServeClient` talks to either package's server. It is the declarative
layer both packages have: `repro_torch.scenarios.ScenarioSpec` is all
primitives (the same fields as the JAX package's), so a scenario travels
as its spec fields and the server materializes the flows — callers never
serialize flow lists or numpy arrays.

    POST /simulate   {"spec": {...ScenarioSpec fields...},
                      "backend": "flowsim_fast",     # optional, one lane
                      "timeout": 5.0,                # optional queue bound
                      "options": {"seed": 1}}        # SimRequest options
        -> 200 {"fcts": [...], "slowdowns": [...], "wall_time": ...}
        -> 400 malformed body / unknown spec field or backend
        -> 503 ServiceOverloaded (Retry-After header) or service closed
        -> 504 request sat queued past its deadline
    GET  /metrics    -> 200 ServiceMetrics snapshot (see serve.metrics);
                        Prometheus text format (version 0.0.4) when the
                        Accept header asks for text/plain or the query
                        string says ?format=prometheus
    GET  /healthz    -> 200 {"ok": true, "status": "ok", ...} healthy;
                        503 with status "degraded" (a lane's dispatcher
                        thread died) or "closed"

`ThreadingHTTPServer` gives one handler thread per connection; handlers
block on their request's future, so concurrency and batching live
entirely in `SimService`, and no handler thread touches the card.
`ServeClient` is the matching urllib client used by the CLI smoke
workload and the tests.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.error import HTTPError
from urllib.parse import parse_qs, urlsplit
from urllib.request import Request, urlopen

from ..scenarios.spec import ScenarioSpec
from ..sim import SimRequest
from .metrics import prometheus_text
from .service import (RequestTimeout, ServiceClosed, ServiceOverloaded,
                      SimService)

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# simulations can legitimately take a long first call (a graph capture);
# handler threads wait this long on the future before giving up
RESULT_WAIT_S = 600.0

_ALLOWED_OPTIONS = {"seed", "until"}    # record_events: raw doesn't travel


def request_from_wire(body: dict) -> SimRequest:
    """Materialize the posted spec dict into a `SimRequest`.

    Raises ValueError on anything malformed (mapped to HTTP 400)."""
    if not isinstance(body, dict) or "spec" not in body:
        raise ValueError('body must be a JSON object with a "spec" field')
    spec_fields = dict(body["spec"])
    if "net" in spec_fields:            # JSON has no tuples
        spec_fields["net"] = tuple(
            (str(k), float(v)) for k, v in spec_fields["net"])
    try:
        spec = ScenarioSpec(**spec_fields)
    except TypeError as exc:
        raise ValueError(f"bad spec: {exc}") from None
    options = dict(body.get("options") or {})
    unknown = set(options) - _ALLOWED_OPTIONS
    if unknown:
        raise ValueError(f"unsupported options {sorted(unknown)} "
                         f"(allowed: {sorted(_ALLOWED_OPTIONS)})")
    return spec.to_request(**options)


class _Handler(BaseHTTPRequestHandler):
    # quiet by default: an always-on service logging every request to
    # stderr is noise; flip server.verbose for debugging
    def log_message(self, fmt, *args):
        if getattr(self.server, "verbose", False):
            BaseHTTPRequestHandler.log_message(self, fmt, *args)

    def _send(self, code: int, payload: dict, headers=()):
        raw = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(raw)

    def _send_text(self, code: int, text: str, content_type: str):
        raw = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def _wants_prometheus(self, query: dict) -> bool:
        fmt = query.get("format") or []
        if "prometheus" in fmt:
            return True
        if "json" in fmt:
            return False
        accept = self.headers.get("Accept", "")
        return ("text/plain" in accept
                or "application/openmetrics-text" in accept)

    def do_GET(self):
        service: SimService = self.server.service
        url = urlsplit(self.path)
        if url.path == "/metrics":
            # content negotiation: JSON stays the default (existing
            # clients), Prometheus scrape config opts in via Accept or
            # ?format=prometheus
            if self._wants_prometheus(parse_qs(url.query)):
                self._send_text(200, prometheus_text(service.metrics()),
                                PROMETHEUS_CONTENT_TYPE)
            else:
                self._send(200, service.metrics())
        elif self.path == "/healthz":
            health = service.health()
            # degraded/closed -> 503 so LB health checks route away
            self._send(200 if health["ok"] else 503, health)
        else:
            self._send(404, {"error": f"no route {self.path!r}"})

    def do_POST(self):
        if self.path != "/simulate":
            self._send(404, {"error": f"no route {self.path!r}"})
            return
        service: SimService = self.server.service
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            request = request_from_wire(body)
            timeout = body.get("timeout")
            future = service.submit(request, backend=body.get("backend"),
                                    timeout=timeout)
        except (ValueError, KeyError) as exc:
            self._send(400, {"error": str(exc)})
            return
        except ServiceOverloaded as exc:
            self._send(503, {"error": str(exc),
                             "retry_after_s": exc.retry_after_s},
                       headers=[("Retry-After",
                                 f"{exc.retry_after_s:.3f}")])
            return
        except ServiceClosed as exc:
            self._send(503, {"error": str(exc)})
            return
        try:
            result = future.result(timeout=RESULT_WAIT_S)
        except (RequestTimeout, TimeoutError) as exc:
            self._send(504, {"error": str(exc) or "request timed out"})
            return
        except ServiceClosed as exc:
            self._send(503, {"error": str(exc)})
            return
        except Exception as exc:        # simulation failed: the original
            self._send(500, {"error": f"{type(exc).__name__}: {exc}"})
            return
        self._send(200, {"fcts": [float(x) for x in result.fcts],
                         "slowdowns": [float(x) for x in result.slowdowns],
                         "wall_time": float(result.wall_time),
                         "backend": result.backend})


class SimHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer bound to a SimService."""
    daemon_threads = True

    def __init__(self, address, service: SimService, verbose: bool = False):
        super().__init__(address, _Handler)
        self.service = service
        self.verbose = verbose


def start_http_server(service: SimService, host: str = "127.0.0.1",
                      port: int = 0, verbose: bool = False) -> SimHTTPServer:
    """Bind and serve in a daemon thread; port=0 picks a free port
    (read it back from `server.server_address`). Stop with
    `server.shutdown(); server.server_close()` — then `service.close()`
    to drain the dispatchers."""
    server = SimHTTPServer((host, port), service, verbose=verbose)
    thread = threading.Thread(target=server.serve_forever,
                              name="serve-http", daemon=True)
    thread.start()
    return server


class ServeClient:
    """Minimal urllib client for the front-end (tests, smoke, docs)."""

    def __init__(self, base_url: str, timeout_s: float = RESULT_WAIT_S):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s

    def _call(self, path: str, payload: Optional[dict] = None) -> dict:
        req = Request(self.base_url + path,
                      data=(None if payload is None
                            else json.dumps(payload).encode()),
                      headers={"Content-Type": "application/json"})
        with urlopen(req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read())

    def simulate(self, spec: dict, backend: Optional[str] = None,
                 timeout: Optional[float] = None,
                 options: Optional[dict] = None) -> dict:
        body: dict = {"spec": spec}
        if backend is not None:
            body["backend"] = backend
        if timeout is not None:
            body["timeout"] = timeout
        if options:
            body["options"] = options
        return self._call("/simulate", body)

    def metrics(self) -> dict:
        return self._call("/metrics")

    def metrics_prometheus(self) -> str:
        """The /metrics body in Prometheus text format (raw text)."""
        req = Request(self.base_url + "/metrics?format=prometheus",
                      headers={"Accept": "text/plain"})
        with urlopen(req, timeout=self.timeout_s) as resp:
            return resp.read().decode()

    def health(self) -> dict:
        """The /healthz body. A degraded or closed service answers 503
        with the same JSON shape — returned here, not raised, so callers
        can always inspect `status`/`dead_lanes`."""
        try:
            return self._call("/healthz")
        except HTTPError as exc:
            return json.loads(exc.read())
