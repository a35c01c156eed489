"""The weight bridge between the JAX package's parameter tree and the port.

Both packages use one tree: nested dicts of arrays, with `gnn` a list of
per-round dicts, weights `(d_in, d_out)` and GRU weights `(d_in, 3H)` in
gate order r, z, n; the LM's trees are nested dicts of leaves stacked
on a leading layer axis, bfloat16 at full size. The bridge therefore
copies leaves and changes nothing else; for float32 trees
`params_to_numpy(params_from_jax(tree))` is bitwise `tree`.
The caller hands over the JAX tree as numpy arrays (`jax.device_get`), so
this module needs no JAX.

`tree_leaves` and `tree_digest` walk a tree in the order of
`jax.tree_util` flattening, which the checkpoints and the weights identity
of both packages share.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` and of the trees of its structure in
    `rest`, leaf by leaf; dicts stay dicts, lists and tuples become
    lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def params_from_jax(tree, device) -> dict:
    """JAX parameter tree (leaves numpy-convertible) -> the port's
    parameters on `device`: float32 leaves as float32 tensors, bfloat16
    leaves (numpy's `bfloat16` dtype of JAX's arrays) as `torch.bfloat16`
    tensors carried bitwise through their 16-bit words."""
    def leaf(x):
        if is_bfloat16(x):
            words = np.ascontiguousarray(x).view(np.int16)
            return torch.from_numpy(words.copy()).view(
                torch.bfloat16).to(device)
        a = np.asarray(x)
        if a.dtype != np.float32:
            raise TypeError(f"expected float32 or bfloat16 weights, got "
                            f"{a.dtype}")
        return torch.from_numpy(np.array(a, copy=True)).to(device)
    return tree_map(leaf, tree)


def params_to_numpy(params) -> dict:
    """The port's parameters -> the same tree of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


def params_to(params, device) -> dict:
    """The same parameters on another device."""
    return tree_map(lambda t: t.to(device), params)


def leaf_numpy(x) -> np.ndarray:
    """A leaf of a tree (tensor on any device, or numpy) as numpy; a
    `torch.bfloat16` tensor, which numpy cannot hold, as its float32
    values (exact)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def is_bfloat16(x) -> bool:
    """A `torch.bfloat16` tensor, or a numpy array of the `bfloat16` dtype
    that JAX's arrays convert to (known by its name: the port never
    imports `ml_dtypes`)."""
    if isinstance(x, torch.Tensor):
        return x.dtype == torch.bfloat16
    return getattr(getattr(x, "dtype", None), "name", None) == "bfloat16"


def leaf_bytes(x):
    """(dtype name, raw bytes) of a leaf as numpy's view of the JAX
    package's array gives them: a bfloat16 leaf is "bfloat16" and its
    16-bit words."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        words = x.detach().cpu().contiguous().view(torch.int16).numpy()
        return "bfloat16", words.tobytes()
    a = leaf_numpy(x)
    return str(a.dtype), a.tobytes()


def tree_leaves(tree, prefix=""):
    """(path, leaf) pairs in the order of `jax.tree_util` flattening: dict
    keys sorted, lists and tuples by index. Paths are the JAX package's
    `runtime.checkpoint._path_str`: keys and indices joined by "/", with
    no leading slash."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def tree_map_with_path(fn, tree, prefix=""):
    """fn(path, leaf) over the leaves of `tree`, paths as `tree_leaves`
    gives them; the structure (dicts, lists, tuples) is kept."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def tree_digest(tree) -> str:
    """sha256 over every leaf's path, dtype name and bytes, in flattening
    order: the twin of the JAX package's `runtime.checkpoint.tree_digest`,
    so one set of weights digests alike in both packages and on any
    device. The m4 backend's fingerprint and `TrainState.weights_hash`
    use it."""
    h = hashlib.sha256()
    for path, leaf in tree_leaves(tree):
        dtype, raw = leaf_bytes(leaf)
        h.update(path.encode())
        h.update(dtype.encode())
        h.update(raw)
    return h.hexdigest()
