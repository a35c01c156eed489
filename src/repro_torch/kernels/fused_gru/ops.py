"""Wrapper of the fused GRU pair kernel (`kernels/csrc/fused_gru.cu`).

`gru_pair` advances the flow cell and the link cell of one m4 stage in
one launch on the current stream. It checks device, dtype, shape and
contiguity, allocates the outputs with `torch.empty`, raises when the
launch is refused, and counts its launches in `gru_pair.launches`. It
takes CUDA tensors only, and none that requires grad (the kernel has no
backward); `repro_torch.kernels.dispatch` sends CPU tensors
to the plain version in `ref.py`.
"""
from __future__ import annotations

import ctypes

import torch

from .. import build
from .._checks import on_card, ptr, raise_on_error, refuse_grad, stream

_CELL = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int]
_ARGTYPES = _CELL + _CELL + [ctypes.c_int, ctypes.c_void_p]


def _kernel():
    fn = build.library("fused_gru").gru_pair_forward
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _cell_args(name, p, x, h, H):
    din = x.shape[-1]
    on_card(f"{name}.x", x, torch.float32)
    on_card(f"{name}.h", h, torch.float32, (*x.shape[:-1], H))
    on_card(f"{name}.wi", p["wi"], torch.float32, (din, 3 * H))
    on_card(f"{name}.wh", p["wh"], torch.float32, (H, 3 * H))
    on_card(f"{name}.bi", p["bi"], torch.float32, (3 * H,))
    on_card(f"{name}.bh", p["bh"], torch.float32, (3 * H,))
    out = torch.empty_like(h)
    args = [ptr(x), ptr(h), ptr(p["wi"]), ptr(p["wh"]), ptr(p["bi"]),
            ptr(p["bh"]), ptr(out), h.numel() // H, din]
    return out, args


def gru_pair(p_f, p_l, x_f, h_f, x_l, h_l):
    """x_f: (..., Din_f), h_f: (..., H); x_l: (..., Din_l), h_l: (..., H);
    p_*: {"wi": (Din, 3H), "wh": (H, 3H), "bi", "bh": (3H,)}. Leading
    axes are flattened into rows. Returns (h_f', h_l')."""
    refuse_grad("fused_gru.gru_pair", x_f, h_f, x_l, h_l,
                *p_f.values(), *p_l.values())
    H = h_f.shape[-1]
    if h_l.shape[-1] != H:
        raise ValueError(f"hidden widths differ: {H} vs {h_l.shape[-1]}")
    if h_l.device != h_f.device:
        raise ValueError("both cells must lie on one device")
    out_f, args_f = _cell_args("flow", p_f, x_f, h_f, H)
    out_l, args_l = _cell_args("link", p_l, x_l, h_l, H)
    err = _kernel()(*args_f, *args_l, H, stream(h_f.device))
    raise_on_error("fused_gru.gru_pair", err)
    gru_pair.launches += 1
    return out_f, out_l


gru_pair.launches = 0
