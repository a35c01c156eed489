"""Wrapper of the bipartite GraphSAGE kernel (`kernels/csrc/bipartite.cu`).

`bipartite_rounds` runs all the rounds of m4's GNN for a batch of
scenarios in one cooperative launch on the current stream;
`bipartite_round` is the case of one round, on the same kernel. The
wrapper checks device, dtype, shape and contiguity, allocates the outputs
and the kernel's scratch (neighbour lists, aggregates, the rounds before
the last) with `torch.empty`, raises when the launch is refused, and
counts launches of the kernel, from either entry point, in
`bipartite_round.launches`. It takes CUDA tensors only, and none that
requires grad (the kernel has no backward);
`repro_torch.kernels.dispatch` sends CPU tensors to the plain version in
`ref.py`.

The kernel's grid barrier keeps one count per device in the library, so
launches on one device run one at a time, as they do on m4's single
stream.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .._checks import on_card, ptr, raise_on_error, refuse_grad, stream

MAX_LAYERS = 8            # bipartite.cu's MAX_LAYERS
_PTRS = ctypes.POINTER(ctypes.c_void_p)
_ARGTYPES = ([ctypes.c_void_p] * 5 + [_PTRS] * 4 + [ctypes.c_int]
             + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_void_p])


def _kernel():
    fn = build.library("bipartite").bipartite_rounds_forward
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def bipartite_rounds(layers, f, l, edge_f, edge_l, edge_mask, *, out=None):
    """All rounds of `layers` (each {"wf": {"w": (2G, G), "b": (G,)},
    "wl": {...}}) in one launch. f: (..., SF, G), l: (..., SL, G); edge_f:
    (E,) int64, shared by the batch; edge_l: (..., E) int64; edge_mask:
    (..., E) float32. `out` = (f_out, l_out) to write into; fresh tensors
    when None. Returns the last round's (f', l')."""
    refuse_grad("bipartite.bipartite_rounds", f, l, edge_mask,
                *(layer[side][k] for layer in layers
                  for side in ("wf", "wl") for k in ("w", "b")))
    R = len(layers)
    if not 1 <= R <= MAX_LAYERS:
        raise ValueError(f"the kernel runs 1 to {MAX_LAYERS} rounds, got {R}")
    SF, G = f.shape[-2:]
    lead = f.shape[:-2]
    SL, E = l.shape[-2], edge_l.shape[-1]
    B = f.numel() // (SF * G) if SF * G else 0
    on_card("f", f, torch.float32)
    on_card("l", l, torch.float32, (*lead, SL, G))
    on_card("edge_l", edge_l, torch.int64, (*lead, E))
    on_card("edge_mask", edge_mask, torch.float32, (*lead, E))
    on_card("edge_f", edge_f, torch.int64, (E,))
    w = {k: [] for k in ("wf", "wl", "bf", "bl")}
    for i, layer in enumerate(layers):
        for side in ("wf", "wl"):
            on_card(f"layer {i} {side}.w", layer[side]["w"], torch.float32,
                    (2 * G, G))
            on_card(f"layer {i} {side}.b", layer[side]["b"], torch.float32,
                    (G,))
            w[side].append(layer[side]["w"].data_ptr())
            w["b" + side[1]].append(layer[side]["b"].data_ptr())
    fo, lo = out if out is not None else (torch.empty_like(f),
                                          torch.empty_like(l))
    on_card("f_out", fo, torch.float32, f.shape)
    on_card("l_out", lo, torch.float32, l.shape)
    rows = B * (SF + SL)
    fscratch = torch.empty((min(R - 1, 2) + 1) * rows * G + 2 * B * E,
                           dtype=torch.float32, device=f.device)
    iscratch = torch.empty(2 * B * E + rows + 2 * B, dtype=torch.int32,
                           device=f.device)
    arrays = [(ctypes.c_void_p * R)(*w[k]) for k in ("wf", "wl", "bf", "bl")]
    err = _kernel()(ptr(f), ptr(l), ptr(edge_f), ptr(edge_l), ptr(edge_mask),
                    *arrays, R, ptr(fo), ptr(lo), ptr(fscratch),
                    ptr(iscratch), B, SF, SL, G, E, stream(f.device))
    raise_on_error("bipartite.bipartite_rounds", err)
    bipartite_round.launches += 1
    return fo, lo


def bipartite_round(f, l, edge_f, edge_l, edge_mask, wf, wl, bf, bl, *,
                    out=None):
    """One round: wf/wl (2G, G), bf/bl (G,); otherwise as
    `bipartite_rounds`."""
    layer = {"wf": {"w": wf, "b": bf}, "wl": {"w": wl, "b": bl}}
    return bipartite_rounds([layer], f, l, edge_f, edge_l, edge_mask,
                            out=out)


bipartite_round.launches = 0
