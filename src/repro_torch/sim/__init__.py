"""repro_torch.sim — run the port's simulators through one API.

    from repro_torch.sim import SimRequest, get_backend

    req = SimRequest.from_scenario(scenario)
    res = get_backend("m4", params=params, cfg=cfg).run(req)
"""
from .api import SimRequest, SimResult
from .backends import (Backend, M4Backend, get_backend, list_backends,
                       register_backend)

__all__ = ["SimRequest", "SimResult", "Backend", "M4Backend", "get_backend",
           "list_backends", "register_backend"]
