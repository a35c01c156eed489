"""The batch sharding of the batched entry points (`repro.core.sharding`).

m4's `run_many`, flowsim_fast's `run_many` and the batch training step
shard their scenario (or sim) axis the same way: pad the leading batch
axis up to a multiple of the device count by repeating the last row, then
reshape (B, ...) -> (D, ceil(B/D), ...). Shard i runs on device i; the
results come back to the caller's device, where `unshard` drops the pad
replicas. Keeping the pad/unshard semantics in one place means the three
paths cannot drift.

`local_devices(device)` is the port's `jax.local_device_count()`: the
devices a sharded call spreads over. The sharded paths look it up on this
module at call time, so a test (or a smoke run on one card) can patch it
to return two entries of one device, the counterpart of JAX's
`--xla_force_host_platform_device_count`.
"""
from __future__ import annotations

from typing import List

import torch

from ..weights import tree_map


def local_devices(device) -> List[torch.device]:
    """Every visible card, `cuda:0` first, for a CUDA device; `[cpu]` for
    the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def shard_leaves(tree, n_devices: int):
    """(B, ...) leaves -> (D, ceil(B/D), ...), padding by repeating the
    last row. Padded replicas cost compute, never correctness: callers
    drop them by slicing the unsharded result back to B (`unshard`).
    Works on a dict or list of tensors, or a single tensor."""
    def one(col):
        B = col.shape[0]
        per = -(-B // n_devices)
        pad = per * n_devices - B
        if pad:
            col = torch.cat([col, col[-1:].expand((pad,) + col.shape[1:])])
        return col.reshape((n_devices, per) + col.shape[1:])
    return tree_map(one, tree)


def unshard(arr, batch: int):
    """(D, B/D, ...) output -> (B, ...), dropping pad replicas."""
    return arr.reshape((-1,) + tuple(arr.shape[2:]))[:batch]
