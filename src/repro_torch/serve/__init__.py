"""repro_torch.serve — always-on simulation service with dynamic batching.

The port of `repro.serve`: a thread-safe `SimService` that answers cache
hits instantly from the content-hash result cache, coalesces duplicate
in-flight requests, batches misses into shape-bucketed `run_many`
flushes on a deadline (one compiled program per bucket: a captured CUDA
graph on a card), applies bounded-queue backpressure, and drains cleanly
on shutdown — plus a stdlib HTTP front-end whose wire format is the JAX
package's, and a metrics block with p50/p99 queue delay. CLI:

    PYTHONPATH=src python -m repro_torch.serve --backend flowsim_fast --port 8642
    PYTHONPATH=src python -m repro_torch.serve --smoke --device cpu
"""
from .clock import Clock, ManualClock, MonotonicClock
from .http import (ServeClient, SimHTTPServer, request_from_wire,
                   start_http_server)
from .metrics import ServiceMetrics, merge_snapshots
from .service import (RequestTimeout, ServeConfig, ServiceClosed,
                      ServiceOverloaded, SimService)

__all__ = [
    "SimService", "ServeConfig", "ServiceMetrics", "merge_snapshots",
    "ServiceOverloaded", "ServiceClosed", "RequestTimeout",
    "Clock", "ManualClock", "MonotonicClock",
    "SimHTTPServer", "ServeClient", "start_http_server",
    "request_from_wire",
]
