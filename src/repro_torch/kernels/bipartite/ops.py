"""Wrapper of the bipartite GraphSAGE round kernel
(`kernels/csrc/bipartite.cu`).

`bipartite_round` runs one round for a batch of scenarios in one launch
on the current stream; `bipartite_rounds` chains the rounds of m4's GNN,
alternating between two output buffers it allocates. The wrapper checks
device, dtype, shape and contiguity, allocates with `torch.empty`,
raises when the launch is refused, and counts its launches in
`bipartite_round.launches`. It takes CUDA tensors only;
`repro_torch.kernels.dispatch` sends CPU tensors to the plain version in
`ref.py`.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .._checks import on_card, ptr, raise_on_error, stream

_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _kernel():
    fn = build.library("bipartite").bipartite_round_forward
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def bipartite_round(f, l, edge_f, edge_l, edge_mask, wf, wl, bf, bl, *,
                    out=None):
    """f: (..., SF, G), l: (..., SL, G); edge_f: (E,) int64, shared by the
    batch; edge_l: (..., E) int64; edge_mask: (..., E) float32;
    wf/wl: (2G, G); bf/bl: (G,). `out` = (f_out, l_out) to write into;
    fresh tensors when None. Returns (f', l')."""
    SF, G = f.shape[-2:]
    lead = f.shape[:-2]
    SL, E = l.shape[-2], edge_l.shape[-1]
    B = f.numel() // (SF * G)
    on_card("f", f, torch.float32)
    on_card("l", l, torch.float32, (*lead, SL, G))
    on_card("edge_l", edge_l, torch.int64, (*lead, E))
    on_card("edge_mask", edge_mask, torch.float32, (*lead, E))
    on_card("edge_f", edge_f, torch.int64, (E,))
    for name, w in (("wf", wf), ("wl", wl)):
        on_card(name, w, torch.float32, (2 * G, G))
    for name, b in (("bf", bf), ("bl", bl)):
        on_card(name, b, torch.float32, (G,))
    fo, lo = out if out is not None else (torch.empty_like(f),
                                          torch.empty_like(l))
    on_card("f_out", fo, torch.float32, f.shape)
    on_card("l_out", lo, torch.float32, l.shape)
    err = _kernel()(ptr(f), ptr(l), ptr(edge_f), ptr(edge_l),
                    ptr(edge_mask), ptr(wf), ptr(wl), ptr(bf), ptr(bl),
                    ptr(fo), ptr(lo), B, SF, SL, G, E, stream(f.device))
    raise_on_error("bipartite.bipartite_round", err)
    bipartite_round.launches += 1
    return fo, lo


bipartite_round.launches = 0


def bipartite_rounds(layers, f, l, edge_f, edge_l, edge_mask):
    """m4's multi-round GNN: one launch per layer."""
    bufs = [(torch.empty_like(f), torch.empty_like(l)) for _ in range(2)]
    for i, layer in enumerate(layers):
        f, l = bipartite_round(f, l, edge_f, edge_l, edge_mask,
                               layer["wf"]["w"], layer["wl"]["w"],
                               layer["wf"]["b"], layer["wl"]["b"],
                               out=bufs[i % 2])
    return f, l
