"""Production meshes, as `repro.launch.mesh`: functions, not module
constants, so importing this file touches no process group.

A mesh is a `torch.distributed.DeviceMesh` over the ranks of the default
process group. A dry run has no cluster: `init_fake_group` starts torch's
fake group of 512 ranks in this process (the counterpart of JAX's
`--xla_force_host_platform_device_count=512`), where collectives run no
communication and, under `FakeTensorMode`, nothing is allocated. A group
starts once per process, so it is started at 512 and the 256-rank meshes
take ranks 0-255.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DRYRUN_RANKS = 512


def init_fake_group() -> None:
    """Start the fake process group of DRYRUN_RANKS ranks, this process
    rank 0; nothing if a group is already up."""
    if dist.is_initialized():
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=DRYRUN_RANKS)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_debug_mesh(n_data: int = 2, n_model: int = 2) -> DeviceMesh:
    """Small mesh for CI on a handful of ranks."""
    return _mesh((n_data, n_model), ("data", "model"))


def _mesh(shape, axes) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_fake_group() for a "
                           "dry run, or torch.distributed."
                           "init_process_group")
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks, the group has "
                         f"{dist.get_world_size()}")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)
