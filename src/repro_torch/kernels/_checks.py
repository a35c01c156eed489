"""Argument checks shared by the kernel wrappers: a kernel gets pointers
only after its tensors were checked here, since it sees no shapes."""
from __future__ import annotations

import ctypes

import torch


def refuse_grad(kernel: str, *tensors) -> None:
    """A kernel defines no backward: refuse inputs that autograd would
    differentiate through it, instead of returning outputs with no
    `grad_fn` and so, silently, zero gradients upstream. The
    differentiated step takes the plain versions by passing plain=True
    (`repro_torch.core.model`, `repro_torch.kernels.dispatch`)."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the kernel has no backward, and an input requires "
            "grad; differentiate through the plain version instead "
            "(plain=True in repro_torch.core.model and kernels.dispatch)")


def on_card(name: str, t: torch.Tensor, dtype: torch.dtype,
            shape: tuple | None = None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on_error(kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: launch failed with cudaError_t {err}")
