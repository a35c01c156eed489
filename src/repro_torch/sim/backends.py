"""The port's backend protocol and string-keyed registry.

A registry of its own, beside `repro.sim`'s: the port plugs into nothing
of the JAX package. Four simulators are registered:

    from repro_torch.sim import get_backend, run_closed_loop

    get_backend("packet").run(req)                   # the DES, ground truth
    get_backend("flowsim").run(req)                  # numpy, the CPU baseline
    get_backend("flowsim_fast").run_many(reqs)       # flowSim on the card
    backend = get_backend("m4", params=params, cfg=cfg)   # device="cuda"
    backend.run(req)          # one scenario
    backend.run_many(reqs)    # one padded batch of arenas
    backend.run_chunked(reqs, 8)   # footprint-sorted chunks of run_many
    run_closed_loop(backend, topo, config, backlog, inflight)

`flowsim_fast` and `m4` take `device`, which defaults to "cuda": they
raise when no card is present and never carry on silently on the CPU.
Pass device="cpu" to run the plain PyTorch versions of the kernels.
`packet` and `flowsim` run on the host in both packages.

Their `run_many` opens the span `sim.run_many` (`repro_torch.obs.trace`:
a JSONL record under `REPRO_TRACE_DIR`, a `torch.profiler` range while
the profiler records), with the loop's spans below it: `sim.prep`,
`sim.upload`, (flowSim) `sim.incidence`, `compiled.run`, `sim.readback`
and `sim.results`.
"""
from __future__ import annotations

import copy
import hashlib
import time
from typing import Callable, Dict, List, Sequence

import torch

import numpy as np

from ..obs.trace import get_tracer
from ..weights import params_to, tree_digest
from .api import SimRequest, SimResult

_REGISTRY: Dict[str, Callable[..., "Backend"]] = {}


def register_backend(name: str, factory: Callable[..., "Backend"] = None):
    """Register a backend factory under `name` (usable as a decorator)."""
    def _add(f):
        _REGISTRY[name] = f
        return f
    return _add(factory) if factory is not None else _add


def get_backend(name: str, **kwargs) -> "Backend":
    """Instantiate the backend registered under `name`; kwargs go to its
    factory (m4: `params`, `cfg`, `device`; flowsim_fast: `device`)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown backend {name!r}; "
                       f"available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def list_backends() -> List[str]:
    return sorted(_REGISTRY)


class Backend:
    """A simulator behind the request/response API."""

    name: str = "?"

    def run(self, request: SimRequest) -> SimResult:
        raise NotImplementedError

    def run_many(self, requests: Sequence[SimRequest]) -> List[SimResult]:
        return [self.run(r) for r in requests]

    def run_chunked(self, requests: Sequence[SimRequest],
                    chunk_size: int = None) -> List[SimResult]:
        """Partition `requests` into shape-compatible chunks and
        `run_many` each: sorted by arena footprint (flow count, then link
        count) so each chunk pads to near-uniform shapes. Results come
        back in input order; `chunk_size=None` runs one chunk. This is
        what `repro_torch.scenarios.SweepRunner` dispatches through."""
        requests = list(requests)
        if chunk_size is None or chunk_size >= len(requests):
            return self.run_many(requests)
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        order = sorted(range(len(requests)),
                       key=lambda i: (requests[i].num_flows,
                                      requests[i].topo.num_links))
        out: List[SimResult] = [None] * len(requests)
        for lo in range(0, len(order), chunk_size):
            chunk = order[lo:lo + chunk_size]
            for i, res in zip(chunk, self.run_many([requests[i]
                                                    for i in chunk])):
                out[i] = res
        return out

    def fingerprint(self) -> str:
        """Identity string for result caching: two backends with the same
        fingerprint must produce identical results for the same request."""
        return self.name

    def closed_loop(self, topo, config, flows):
        """Open a `ClosedLoopSession` (dynamic arrivals)."""
        raise NotImplementedError(
            f"backend {self.name!r} has no closed-loop session")


def _batch_probes(requests: Sequence[SimRequest]):
    """One batch of arenas runs one event loop, so every request must
    carry the same ProbeConfig (as one compiled program does in the JAX
    package)."""
    probes = {r.probes for r in requests}
    if len(probes) > 1:
        raise ValueError(
            "run_many requires a uniform `probes` setting across the batch")
    return probes.pop() if probes else None


def resolve_device(device) -> torch.device:
    """The device a backend runs on; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "to run the plain PyTorch versions instead")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def _root_span(lane: str, requests: Sequence[SimRequest]):
    """The span of one `run_many` call (`sim.run_many`): the lane, its
    scenarios and flows; the loop adds the padded sizes."""
    return get_tracer().span("sim.run_many", attrs={
        "lane": lane, "scenarios": len(requests),
        "flows": sum(r.num_flows for r in requests)})


def _result(name, r) -> SimResult:
    return SimResult(fcts=r.fcts, slowdowns=r.slowdowns,
                     wall_time=r.wallclock, backend=name, probes=r.probes,
                     raw=r)


@register_backend("packet")
class PacketBackend(Backend):
    """The reduced packet-level DES (the ns-3 stand-in): ground truth. A
    host-side event loop by nature, it takes no device, and so does its
    closed-loop session (`PacketSession`)."""

    name = "packet"

    def run(self, request: SimRequest) -> SimResult:
        from ..net.packetsim import PacketSim
        flows = copy.deepcopy(list(request.flows))   # DES mutates flow state
        t0 = time.perf_counter()
        trace = PacketSim(request.topo, request.config,
                          seed=request.seed).run(flows, until=request.until)
        wall = time.perf_counter() - t0
        done = np.array([f.done for f in trace.flows])
        fcts = np.where(done, trace.fcts, np.nan)
        sldn = np.where(done, trace.slowdowns, np.nan)
        kw = {}
        if request.record_events:
            ev = trace.events
            kw = dict(event_times=np.array([e.time for e in ev]),
                      event_types=np.array([e.etype for e in ev]),
                      event_fids=np.array([e.fid for e in ev]),
                      event_remaining=tuple(tuple(e.remaining) for e in ev),
                      event_queues=tuple(tuple(e.path_queues) for e in ev))
        if request.probes is not None:
            # the DES has no device arenas; synthesize the same series
            # schema on the host from its ground-truth event records
            from ..obs.timeseries import series_from_packet_trace
            kw["probes"] = series_from_packet_trace(
                trace, request.probes, num_flows=len(flows))
        return SimResult(fcts=fcts, slowdowns=sldn, wall_time=wall,
                         backend=self.name, raw=trace, **kw)

    def closed_loop(self, topo, config, flows):
        from .closedloop import PacketSession
        return PacketSession(topo, config, flows)


@register_backend("flowsim")
class FlowSimBackend(Backend):
    """Classical max-min flowSim, the numpy event loop (paper §2.1
    baseline); it runs on the host by nature and takes no device. It
    records no probes: a probed request returns `probes=None`, as in the
    JAX package."""

    name = "flowsim"

    def run(self, request: SimRequest) -> SimResult:
        from ..core.flowsim import run_flowsim
        r = run_flowsim(request.topo, list(request.flows),
                        until=request.until,
                        record_events=request.record_events)
        kw = {}
        if request.record_events:
            kw = dict(event_times=r.event_times, event_types=r.event_types,
                      event_fids=r.event_fids)
        return SimResult(fcts=r.fcts, slowdowns=r.slowdowns,
                         wall_time=r.wallclock, backend=self.name, raw=r, **kw)

    def closed_loop(self, topo, config, flows):
        from .closedloop import FlowSimSession
        return FlowSimSession(topo, flows)


@register_backend("flowsim_fast")
class FlowSimFastBackend(Backend):
    """flowSim as an event loop over device arenas, with the water-filling
    row-min kernel on the card; `run_many` pads scenarios to one batch."""

    name = "flowsim_fast"

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def fingerprint(self) -> str:
        """"flowsim_fast_torch-k<cuda|torch>": distinct from the JAX
        package's "flowsim_fast-k<mode>", and from one device to the other
        (kernel vs plain row-min)."""
        kind = "cuda" if self.device.type == "cuda" else "torch"
        return f"flowsim_fast_torch-k{kind}"

    def run(self, request: SimRequest) -> SimResult:
        from ..core.flowsim_fast import run_flowsim_fast
        self._check(request)
        r = run_flowsim_fast(request.topo, list(request.flows), self.device,
                             probes=request.probes)
        return _result(self.name, r)

    def run_many(self, requests: Sequence[SimRequest]) -> List[SimResult]:
        from ..core.flowsim_fast import run_flowsim_fast_batch
        for r in requests:
            self._check(r)
        with _root_span(self.name, requests) as sp:
            results = run_flowsim_fast_batch(
                [(r.topo, list(r.flows)) for r in requests], self.device,
                probes=_batch_probes(requests), span=sp)
            return [_result(self.name, r) for r in results]

    def closed_loop(self, topo, config, flows):
        # closed-loop stepping is event-at-a-time; as in the JAX package,
        # the numpy max-min session runs it (identical fluid semantics)
        from .closedloop import FlowSimSession
        return FlowSimSession(topo, flows)

    @staticmethod
    def _check(request: SimRequest):
        if request.until is not None:
            raise NotImplementedError(
                "flowsim_fast runs the full trace; `until` unsupported")


@register_backend("m4")
class M4Backend(Backend):
    """The learned flow-level simulator: the port's parameters (see
    `repro_torch.core.model.init_m4` / `repro_torch.weights`) + `M4Config`.
    `run_many` pads the scenarios to one batch of arenas."""

    name = "m4"

    def __init__(self, params=None, cfg=None, device="cuda"):
        if params is None or cfg is None:
            raise ValueError(
                'm4 backend needs model parameters: '
                'get_backend("m4", params=params, cfg=cfg)')
        self.device = resolve_device(device)
        self.params, self.cfg = params_to(params, self.device), cfg
        self._fingerprint = None

    def fingerprint(self) -> str:
        """"m4_torch-<sha256 of cfg + weights>-k<cuda|torch>": distinct from
        the JAX package's "m4-..." so cached results never mix packages,
        and from one device to the other (kernels vs plain versions). The
        weights enter as `tree_digest`, the digest that
        `TrainState.weights_hash` reports and the JAX package's
        `tree_digest` computes for the same weights."""
        if self._fingerprint is None:
            h = hashlib.sha256(
                (repr(self.cfg) + tree_digest(self.params)).encode())
            kind = "cuda" if self.device.type == "cuda" else "torch"
            self._fingerprint = f"m4_torch-{h.hexdigest()[:16]}-k{kind}"
        return self._fingerprint

    def run(self, request: SimRequest) -> SimResult:
        from ..core.simulate import simulate_open_loop
        self._check(request)
        r = simulate_open_loop(self.params, self.cfg, request.topo,
                               request.config, list(request.flows),
                               probes=request.probes)
        return _result(self.name, r)

    def run_many(self, requests: Sequence[SimRequest]) -> List[SimResult]:
        from ..core.simulate import simulate_open_loop_batch
        for r in requests:
            self._check(r)
        with _root_span(self.name, requests) as sp:
            results = simulate_open_loop_batch(
                self.params, self.cfg,
                [(r.topo, r.config, list(r.flows)) for r in requests],
                probes=_batch_probes(requests), span=sp)
            return [_result(self.name, r) for r in results]

    def closed_loop(self, topo, config, flows):
        from ..core.simulate import M4Simulator
        return M4Simulator(self.params, self.cfg, topo, config, list(flows))

    @staticmethod
    def _check(request: SimRequest):
        if request.until is not None:
            raise NotImplementedError(
                "m4 predicts the full trace; `until` unsupported")
