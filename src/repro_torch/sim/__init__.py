"""repro_torch.sim — run the port's simulators through one API.

    from repro_torch.sim import SimRequest, get_backend, run_closed_loop

    req = SimRequest.from_scenario(scenario)
    res = get_backend("m4", params=params, cfg=cfg).run(req)
    res = get_backend("flowsim_fast").run_many(reqs)
    res = get_backend("flowsim_fast").run_chunked(reqs, 8)
    cl = run_closed_loop(get_backend("packet"), topo, config, backlog, 3)

Backends: "packet" (the packet DES, ground truth), "flowsim" (numpy
max-min reference), "flowsim_fast" (flowSim on the card), "m4" (the
learned simulator). Closed-loop workloads go through
`run_closed_loop(backend, ...)`, for every backend (the packet DES
through `PacketSession`).
"""
from .api import SimRequest, SimResult
from .backends import (Backend, FlowSimBackend, FlowSimFastBackend,
                       M4Backend, PacketBackend, get_backend, list_backends,
                       register_backend)
from .closedloop import (ClosedLoopResult, ClosedLoopSession, FlowSimSession,
                         PacketSession, run_closed_loop)

__all__ = ["SimRequest", "SimResult", "Backend", "FlowSimBackend",
           "FlowSimFastBackend", "M4Backend", "PacketBackend", "get_backend",
           "list_backends", "register_backend", "ClosedLoopResult",
           "ClosedLoopSession", "FlowSimSession", "PacketSession",
           "run_closed_loop"]
