"""Wrappers of the water-filling kernels (`kernels/csrc/waterfill.cu`).

`waterfill_event` computes one flowSim event's whole water-filling (up to
32 rounds) for a batch of scenarios in one launch, on the incidence lists
of `layout.lists_from_links`; `masked_rowmin` computes one round's per-flow
bottleneck share over a dense incidence (off flowSim's path since the
event kernel; the counterpart of the JAX package's `masked_rowmin`).

Each launches on the current stream, checks device, dtype, shape and
contiguity, allocates its outputs (and the event kernel's scratch, where
its flow state does not fit in shared memory) with `torch.empty`, raises
when the launch is refused, and counts its launches in `.launches`. They
take CUDA tensors only, and none that requires grad (the kernels have no
backward); `repro_torch.kernels.dispatch` sends CPU tensors
to the plain versions in `ref.py`.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .._checks import on_card, ptr, raise_on_error, refuse_grad, stream
from .layout import IncidenceLists, plan
from .ref import MAX_ROUNDS

_ROWMIN_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p]
_EVENT_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] \
    + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _kernel(name, argtypes):
    fn = getattr(build.library("waterfill"), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def masked_rowmin(a, share):
    """a: (..., F, L) 0/1 incidence; share: (..., L), float32. Leading axes
    are flattened into scenarios. Returns (..., F)."""
    refuse_grad("waterfill.masked_rowmin", a, share)
    F, L = a.shape[-2:]
    lead = a.shape[:-2]
    on_card("a", a, torch.float32)
    on_card("share", share, torch.float32, (*lead, L))
    out = torch.empty(*lead, F, dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    err = _kernel("masked_rowmin_forward", _ROWMIN_ARGTYPES)(
        ptr(a), ptr(share), ptr(out), out.numel() // F, F, L,
        stream(a.device))
    raise_on_error("waterfill.masked_rowmin", err)
    masked_rowmin.launches += 1
    return out


masked_rowmin.launches = 0


def waterfill_event(lists: IncidenceLists, cap, active, *,
                    max_rounds=MAX_ROUNDS):
    """Max-min rates of the active flows of B scenarios (see
    `ref.waterfill_event_ref`). lists: the run's `lists_from_links`; cap
    (B, L) float32; active (B, N) bool. Returns (rates (B, N) float32,
    rounds (B,) int32, capped (B,) bool). Where the event does not fit in
    shared memory (`layout.plan`), the kernel keeps its flow state in a
    scratch of device memory, allocated here."""
    refuse_grad("waterfill.waterfill_event", cap, active)
    B, N, K = lists.flow_links.shape
    L = lists.link_ptr.shape[1] - 1
    on_card("flow_links", lists.flow_links, torch.int32)
    on_card("flow_entries", lists.flow_entries, torch.int32, (B, N, K))
    on_card("link_ptr", lists.link_ptr, torch.int32, (B, L + 1))
    on_card("cap", cap, torch.float32, (B, L))
    on_card("active", active, torch.bool, (B, N))
    dev = active.device
    rates = torch.empty(B, N, dtype=torch.float32, device=dev)
    rounds = torch.empty(B, dtype=torch.int32, device=dev)
    capped = torch.empty(B, dtype=torch.bool, device=dev)
    _, stride = plan(N, L, K, lists.nnz)
    scratch = (torch.empty(B, stride, dtype=torch.uint8, device=dev)
               if stride else None)
    err = _kernel("waterfill_event_forward", _EVENT_ARGTYPES)(
        ptr(lists.flow_links), ptr(lists.flow_entries), ptr(lists.link_ptr),
        ptr(cap), ptr(active), ptr(rates), ptr(rounds), ptr(capped),
        None if scratch is None else ptr(scratch), stride, B, N, L, K,
        lists.nnz, max_rounds, stream(dev))
    raise_on_error("waterfill.waterfill_event", err)
    waterfill_event.launches += 1
    return rates, rounds, capped


waterfill_event.launches = 0
