"""The sparse layout of the per-event water-filling kernel, in plain
PyTorch (it runs on the CPU too, where the tests reach it).

A flowSim run's incidence arrives as rows: per flow its links, ascending,
-1 padded (`core.flowsim_fast._pack` writes them from each flow's path).
`lists_from_links` turns those rows into the lists the kernel walks: per
flow its links, per link the range of its entries (CSR offsets), and per
flow the places of its entries in those ranges (the kernel keeps a copy
of each flow's state there, so that a link's sums read its entries in
order). The work is O(B·N·K), and no dense (B, N, L) array is made. The
incidence is the same for every event of a run, so the lists are built
once per run; their sizes (K, nnz) are known before the event loop
starts, which keeps that loop free of host syncs.

`dense_incidence` is the (B, N, L) 0/1 array of the same rows, which the
CPU's plain water-filling reads, and `incidence_lists` the same lists
built from such a dense array: the tests hold `lists_from_links` to it.

`plan` chooses between the kernel's two placements, as
`csrc/waterfill.cu` lays them out: every per-scenario array in shared
memory, or (where they do not fit, past ~4k flows at 2-4 links a flow)
the lists and the flow state in device memory.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# a Hopper block's dynamic shared memory (232,448 bytes) less the
# kernel's static reduction slots, with room to spare
SMEM_BUDGET = 227 * 1024 - 1024


class IncidenceLists(NamedTuple):
    """flow_links (B, N, K) int32: flow f's links, ascending, -1 padded,
    K the largest hop count; link_ptr (B, L + 1) int32: link l's entries
    are link_ptr[b, l] : link_ptr[b, l + 1], one per flow it carries, in
    ascending flow order; flow_entries (B, N, K) int32: the entry of flow
    f in the range of its link flow_links[b, f, k] (-1 where flow_links
    is); nnz, the largest entry count of a scenario."""
    flow_links: torch.Tensor
    link_ptr: torch.Tensor
    flow_entries: torch.Tensor
    nnz: int


def incidence_lists(a: torch.Tensor) -> IncidenceLists:
    """Per-flow link lists and per-link entry ranges (CSR) of a (B, N, L)
    0/1 incidence, on its device. Two host syncs (K and nnz)."""
    B, N, L = a.shape
    on = a > 0
    dev = a.device
    K = int(on.sum(-1).max()) if N * L else 0
    # a flow's links first, in ascending order; L marks "no link"
    ids = torch.where(on, torch.arange(L, dtype=torch.long, device=dev), L)
    ids = ids.sort(-1).values[..., :K]
    flow_links = torch.where(ids < L, ids, -1).to(torch.int32).contiguous()
    link_ptr = torch.zeros(B, L + 1, dtype=torch.int32, device=dev)
    link_ptr[:, 1:] = on.sum(1).cumsum(-1)
    nnz = link_ptr[:, -1].long()
    # row-major nonzeros of (B, L, N): by scenario, then link, then flow
    b, l, f = on.transpose(1, 2).nonzero(as_tuple=True)
    start = torch.cumsum(nnz, 0) - nnz
    pos = torch.arange(b.numel(), dtype=torch.long, device=dev) - start[b]
    # entry_of[b, f, l]: the place of f in link l's range (column L: none)
    entry_of = torch.zeros(B, N, L + 1, dtype=torch.int32, device=dev)
    entry_of[b, f, l] = pos.to(torch.int32)
    col = torch.where(flow_links >= 0, flow_links, L).long()
    flow_entries = torch.where(flow_links >= 0, entry_of.gather(-1, col),
                               -1).to(torch.int32).contiguous()
    return IncidenceLists(flow_links, link_ptr, flow_entries,
                          int(nnz.max()) if B else 0)


def lists_from_links(links: torch.Tensor, num_links: int) -> IncidenceLists:
    """`incidence_lists` of the incidence whose rows are `links` (B, N, K')
    int32: flow f's links, ascending and distinct, then -1 padding; on
    their device, in O(B·N·K') work. Two host syncs (K and nnz)."""
    B, N, _ = links.shape
    L, dev = num_links, links.device
    on = links >= 0
    K = int(on.sum(-1).max()) if on.numel() else 0
    flow_links = links[..., :K].contiguous()
    on = on[..., :K]
    # each entry keyed by (scenario, link); no link: B * L, past them all
    b = torch.arange(B, dtype=torch.long, device=dev)[:, None, None]
    key = torch.where(on, b * L + flow_links.long(), B * L).flatten()
    per_link = torch.bincount(key, minlength=B * L + 1)[:B * L]
    link_ptr = torch.zeros(B, L + 1, dtype=torch.int32, device=dev)
    link_ptr[:, 1:] = per_link.view(B, L).cumsum(-1)
    nnz = link_ptr[:, -1].long()
    # the entries in (scenario, link, flow) order: the rows give them in
    # (scenario, flow) order, and a stable sort by (scenario, link) keeps
    # each link's flows ascending
    order = torch.argsort(key, stable=True)
    start = torch.cumsum(nnz, 0) - nnz
    first = torch.div(key[order], L, rounding_mode="floor").clamp(max=B - 1)
    pos = torch.empty_like(key)
    pos[order] = torch.arange(key.numel(), dtype=torch.long,
                              device=dev) - start[first]
    flow_entries = torch.where(on, pos.view(B, N, K),
                               -1).to(torch.int32).contiguous()
    return IncidenceLists(flow_links, link_ptr, flow_entries,
                          int(nnz.max()) if B else 0)


def dense_incidence(links: torch.Tensor, num_links: int,
                    dtype=torch.float32) -> torch.Tensor:
    """The (B, N, L) 0/1 incidence whose rows are `links` (B, N, K),
    -1 entries skipped, on their device."""
    B, N, _ = links.shape
    a = torch.zeros(B, N, num_links + 1, dtype=dtype, device=links.device)
    idx = torch.where(links >= 0, links, num_links).long()
    a.scatter_(-1, idx, 1.0)
    return a[..., :num_links].contiguous()


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def plan(N: int, L: int, K: int, nnz: int):
    """(smem_bytes, scratch_bytes) of one scenario, one of them 0: the
    shared memory of the placement with every array on chip (link_ptr,
    cap, share, rate, entry, flow_links, fshare, flow_entries, each
    16-byte aligned) where it fits in SMEM_BUDGET; else the device-memory
    scratch of the other placement (share, entry, fshare; the kernel reads
    the lists from its inputs and keeps the rates in its output)."""
    smem = sum(_align16(4 * n) for n in (L + 1, L, L, N, nnz, N * K, N,
                                         N * K))
    if smem <= SMEM_BUDGET:
        return smem, 0
    return 0, sum(_align16(4 * n) for n in (L, nnz, N))
