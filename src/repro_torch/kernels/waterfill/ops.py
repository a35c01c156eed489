"""Wrapper of the water-filling row-min kernel (`kernels/csrc/waterfill.cu`).

`masked_rowmin` computes, per flow, the min of `share` over the links
the flow crosses (INF for none), for a batch of scenarios in one launch
on the current stream. It checks device, dtype, shape and contiguity,
allocates the output with `torch.empty`, raises when the launch is
refused, and counts its launches in `masked_rowmin.launches`. It takes
CUDA tensors only; `repro_torch.kernels.dispatch` sends CPU tensors to
the plain version in `ref.py`.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .._checks import on_card, ptr, raise_on_error, stream

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _kernel():
    fn = build.library("waterfill").masked_rowmin_forward
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def masked_rowmin(a, share):
    """a: (..., F, L) 0/1 incidence; share: (..., L), float32. Leading axes
    are flattened into scenarios. Returns (..., F)."""
    F, L = a.shape[-2:]
    lead = a.shape[:-2]
    on_card("a", a, torch.float32)
    on_card("share", share, torch.float32, (*lead, L))
    out = torch.empty(*lead, F, dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    err = _kernel()(ptr(a), ptr(share), ptr(out), out.numel() // F, F, L,
                    stream(a.device))
    raise_on_error("waterfill.masked_rowmin", err)
    masked_rowmin.launches += 1
    return out


masked_rowmin.launches = 0
