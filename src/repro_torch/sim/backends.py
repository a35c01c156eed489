"""The port's backend protocol and string-keyed registry.

A registry of its own, beside `repro.sim`'s: the port plugs into nothing
of the JAX package. Only the learned simulator is here so far:

    from repro_torch.sim import get_backend

    backend = get_backend("m4", params=params, cfg=cfg)   # device="cuda"
    backend.run(req)          # one scenario
    backend.run_many(reqs)    # one padded batch of arenas

`device` defaults to "cuda" and the backend raises when no card is
present; it never carries on silently on the CPU. Pass device="cpu" to
run the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Sequence

import torch

from ..weights import params_to, weights_digest
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
    factory (m4: `params`, `cfg`, `device`)."""
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

    def fingerprint(self) -> str:
        """Identity string for result caching."""
        return self.name


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
        and from one device to the other (kernels vs plain versions)."""
        if self._fingerprint is None:
            h = hashlib.sha256(
                (repr(self.cfg) + weights_digest(self.params)).encode())
            kind = "cuda" if self.device.type == "cuda" else "torch"
            self._fingerprint = f"m4_torch-{h.hexdigest()[:16]}-k{kind}"
        return self._fingerprint

    def run(self, request: SimRequest) -> SimResult:
        from ..core.simulate import simulate_open_loop
        self._check(request)
        r = simulate_open_loop(self.params, self.cfg, request.topo,
                               request.config, list(request.flows))
        return SimResult(fcts=r.fcts, slowdowns=r.slowdowns,
                         wall_time=r.wallclock, backend=self.name, raw=r)

    def run_many(self, requests: Sequence[SimRequest]) -> List[SimResult]:
        from ..core.simulate import simulate_open_loop_batch
        for r in requests:
            self._check(r)
        results = simulate_open_loop_batch(
            self.params, self.cfg,
            [(r.topo, r.config, list(r.flows)) for r in requests])
        return [SimResult(fcts=r.fcts, slowdowns=r.slowdowns,
                          wall_time=r.wallclock, backend=self.name, raw=r)
                for r in results]

    @staticmethod
    def _check(request: SimRequest):
        if request.until is not None:
            raise NotImplementedError(
                "m4 predicts the full trace; `until` unsupported")
        if request.probes is not None:
            raise NotImplementedError("probes are not ported yet")
