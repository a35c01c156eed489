"""The weight bridge between the JAX package's parameter tree and the port.

Both packages use one tree: nested dicts of arrays, with `gnn` a list of
per-round dicts, weights `(d_in, d_out)` and GRU weights `(d_in, 3H)` in
gate order r, z, n. The bridge therefore copies leaves and changes
nothing else; `params_to_numpy(params_from_jax(tree))` is bitwise `tree`.
The caller hands over the JAX tree as numpy arrays (`jax.device_get`), so
this module needs no JAX.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def params_from_jax(tree, device) -> dict:
    """JAX parameter tree (leaves numpy-convertible) -> the port's
    parameters: float32 tensors on `device`."""
    def leaf(x):
        a = np.asarray(x)
        if a.dtype != np.float32:
            raise TypeError(f"expected float32 weights, got {a.dtype}")
        return torch.from_numpy(np.array(a, copy=True)).to(device)
    return _map_tree(leaf, tree)


def params_to_numpy(params) -> dict:
    """The port's parameters -> the same tree of numpy arrays."""
    return _map_tree(lambda t: t.detach().cpu().numpy(), params)


def params_to(params, device) -> dict:
    """The same parameters on another device."""
    return _map_tree(lambda t: t.to(device), params)


def _leaves(params, prefix=""):
    """(path, tensor) pairs, dict keys in sorted order, lists by index."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from _leaves(params[k], f"{prefix}/{k}")
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, params


def weights_digest(params) -> str:
    """sha256 over every leaf's path, dtype, shape and bytes in sorted key
    order: equal weights give equal digests on any device."""
    h = hashlib.sha256()
    for path, t in _leaves(params):
        a = t.detach().cpu().contiguous().numpy()
        h.update(f"{path}|{a.dtype}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()
