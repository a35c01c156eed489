"""Fault-tolerant checkpointing: atomic, hashed, step-addressed, resumable.

Layout:  <dir>/step_<N>/state.msgpack.zst   (+ state.sha256)
         <dir>/step_<N>/COMMITTED           (written last -> crash-safe)

The layout and the bytes of `repro.runtime.checkpoint`: the payload is a
msgpack map {path: (dtype.str, shape, raw bytes)} in the order of
`jax.tree_util` flattening (dict keys sorted, lists by index; paths as
`_path_str` writes them), packed by the port's codec and compressed with
zlib. So a checkpoint written by either package restores in the other bit
for bit, and one tree gives the same `state.sha256` in both. Leaves are
tensors on any device or numpy arrays; `restore` gives each leaf the type
and device of the corresponding leaf of `tree_like`.

A bfloat16 leaf is stored as the JAX package stores it: under the dtype
name "bfloat16", its values widened to float32 (exact), so the port needs
neither `ml_dtypes` nor `jax` to write or read it. It restores as a
`torch.bfloat16` tensor (on the device of a tensor in `tree_like`), or as
an array of `tree_like`'s own bfloat16 dtype where that leaf is one.
"""
from __future__ import annotations

import hashlib
import os
import shutil

import numpy as np
import torch

from ..weights import (is_bfloat16, leaf_numpy, tree_digest, tree_leaves,
                       tree_map_with_path)
from .blobstore import _compress, _decompress
from .codec import packb, unpackb

__all__ = ["save", "restore", "restore_latest_loadable", "latest_step",
           "tree_digest"]


def save(ckpt_dir: str, step: int, tree, *, keep_last: int = 3) -> str:
    """Atomically persist a tree of tensors / arrays at `step`."""
    payload = {}
    for path, leaf in tree_leaves(tree):
        arr = leaf_numpy(leaf)
        if is_bfloat16(leaf):               # the values, widened to float32
            payload[path] = ("bfloat16", list(arr.shape),
                             arr.astype("<f4").tobytes())
        else:
            payload[path] = (arr.dtype.str, list(arr.shape), arr.tobytes())
    comp = _compress(packb(payload))
    digest = hashlib.sha256(comp).hexdigest()

    step_dir = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = step_dir + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, "state.msgpack.zst"), "wb") as f:
        f.write(comp)
    with open(os.path.join(tmp, "state.sha256"), "w") as f:
        f.write(digest)
    with open(os.path.join(tmp, "COMMITTED"), "w") as f:
        f.write(str(step))
    shutil.rmtree(step_dir, ignore_errors=True)
    os.rename(tmp, step_dir)

    for old in sorted(_steps(ckpt_dir))[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{old:010d}"),
                      ignore_errors=True)
    return step_dir


def _steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and \
                os.path.exists(os.path.join(ckpt_dir, d, "COMMITTED")):
            out.append(int(d[5:]))
    return out


def latest_step(ckpt_dir: str):
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str, tree_like, step: int | None = None):
    """Restore into the structure of `tree_like`; returns (tree, step).
    Verifies the integrity hash."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(step_dir, "state.msgpack.zst"), "rb") as f:
        comp = f.read()
    with open(os.path.join(step_dir, "state.sha256")) as f:
        want = f.read().strip()
    if hashlib.sha256(comp).hexdigest() != want:
        raise IOError(f"checkpoint {step_dir} corrupt: hash mismatch")
    payload = unpackb(_decompress(comp))

    def leaf_of(path, like):
        if path not in payload:
            raise KeyError(f"checkpoint missing leaf {path}")
        dt, shape, buf = payload[path]
        if dt == "bfloat16":
            arr = np.frombuffer(buf, "<f4").reshape(shape)
            if not isinstance(like, torch.Tensor) and is_bfloat16(like):
                return arr.astype(like.dtype)
            t = torch.from_numpy(arr.copy()).to(torch.bfloat16)
            return t.to(like.device) if isinstance(like, torch.Tensor) \
                else t
        arr = np.frombuffer(buf, np.dtype(dt)).reshape(shape).copy()
        if isinstance(like, torch.Tensor):
            return torch.from_numpy(arr).to(like.device)
        return arr

    return tree_map_with_path(leaf_of, tree_like), step


def restore_latest_loadable(ckpt_dir: str, tree_like):
    """Restore the newest committed checkpoint that actually loads.

    A committed step can still rot afterwards (disk corruption, a bit
    flip); `restore` detects that by the content hash and raises. This
    walks committed steps newest-first and returns the first that
    restores cleanly, so a single bad epoch costs a rollback instead of
    the whole run.

    Returns (tree, step, skipped) where `skipped` is [(step, reason)] for
    every newer checkpoint that failed to load. Raises FileNotFoundError
    when no committed checkpoint loads at all.
    """
    skipped = []
    for step in sorted(_steps(ckpt_dir), reverse=True):
        try:
            tree, _ = restore(ckpt_dir, tree_like, step=step)
            return tree, step, skipped
        except Exception as exc:
            skipped.append((step, f"{type(exc).__name__}: {exc}"))
    detail = "; ".join(f"step {s}: {r}" for s, r in skipped) or "none found"
    raise FileNotFoundError(
        f"no loadable committed checkpoint in {ckpt_dir} ({detail})")
