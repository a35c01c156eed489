"""The kernel-backed primitives of m4's event and flowSim's event, routed
by device.

A CPU tensor goes to the plain PyTorch version; a CUDA tensor goes to the
hand-written kernel, which launches or raises. There is no environment
override and no fallback: the device the caller chose decides, and
`repro_torch.sim` names it in the backend fingerprint.

The one exception is the keyword `plain=True` of m4's two primitives,
which takes the plain version on any device. Only the differentiated
training step passes it (`repro_torch.core.training`), as the JAX package
trains on its jnp path: the kernels define no backward, and refuse inputs
that require grad.
"""
from __future__ import annotations

import torch

from .bipartite import ref as bipartite_ref
from .fused_gru import ref as gru_ref
from .waterfill import layout as waterfill_layout
from .waterfill import ref as waterfill_ref


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


def count_dispatch(device, *, plain=False) -> None:
    """Count one `kernels.dispatch{mode=cuda|plain}` in the obs registry
    for one entry-point call (an open-loop batch, a flowSim batch, a
    training step) whose primitives run on `device`: the counterpart of
    the JAX package's one count per kernel-mode resolution. Entry points
    count, never launches: the event loops are host-bound, and a locked
    counter per launch would cost every event."""
    from ..obs.registry import get_registry, labeled
    mode = "plain" if plain or torch.device(device).type == "cpu" \
        else "cuda"
    get_registry().inc(labeled("kernels.dispatch", mode=mode))


def gru_cell_pair(p_f, p_l, x_f, h_f, x_l, h_l, *, plain=False):
    """Advance the flow GRU and the link GRU of one stage together
    (params {"wi","wh","bi","bh"} in the repro layout)."""
    if plain or _on_cpu(h_f):
        return gru_ref.gru_pair_ref(p_f, p_l, x_f, h_f, x_l, h_l)
    from .fused_gru.ops import gru_pair
    return gru_pair(p_f, p_l, x_f, h_f, x_l, h_l)


def gnn_rounds(layers, f, l, edge_f, edge_l, edge_mask, num_links, *,
               plain=False):
    """Multi-round bipartite GraphSAGE (m4's spatial model); f (..., SF, G),
    l (..., num_links, G)."""
    if plain or _on_cpu(f):
        m = bipartite_ref.incidence_from_edges(edge_f, edge_l, edge_mask,
                                               f.shape[-2], num_links)
        return bipartite_ref.bipartite_rounds_matmul(layers, f, l, m)
    from .bipartite.ops import bipartite_rounds
    return bipartite_rounds(layers, f, l, edge_f, edge_l, edge_mask)


def masked_rowmin(a, share):
    """Per-flow bottleneck share: min over the flow's links of `share`;
    a (..., F, L) 0/1 incidence, share (..., L)."""
    if _on_cpu(a):
        return waterfill_ref.masked_rowmin_ref(a, share)
    from .waterfill.ops import masked_rowmin as rowmin_kernel
    return rowmin_kernel(a, share)


def waterfill_incidence(links, num_links):
    """The incidence of a flowSim run in the form its device's
    `waterfill_event` reads, built once per run from its rows `links`
    (B, N, K) int32 (each flow's links, ascending, -1 padded) over
    `num_links` links: on the CPU the dense (B, N, L) incidence in float64
    (which saves the plain version a cast per round), on the card the
    lists of `waterfill.layout.lists_from_links`."""
    if _on_cpu(links):
        return waterfill_layout.dense_incidence(links, num_links,
                                                torch.float64)
    return waterfill_layout.lists_from_links(links, num_links)


def waterfill_event(incidence, cap, active, *, max_rounds):
    """One flowSim event's max-min water-filling for B scenarios:
    `incidence` from `waterfill_incidence`; cap (B, L); active (B, N)
    bool. Returns (rates, rounds, capped), see
    `waterfill.ref.waterfill_event_ref`."""
    if _on_cpu(active):
        return waterfill_ref.waterfill_event_ref(incidence, cap, active,
                                                 max_rounds=max_rounds)
    from .waterfill.ops import waterfill_event as event_kernel
    return event_kernel(incidence, cap, active, max_rounds=max_rounds)
