"""The GRU and GNN hot path of one m4 event, routed by device.

A CPU tensor goes to the plain PyTorch version; a CUDA tensor goes to the
hand-written kernel, which launches or raises. There is no environment
override and no fallback: the device the caller chose decides, and
`repro_torch.sim` names it in the backend fingerprint.
"""
from __future__ import annotations

from .bipartite import ref as bipartite_ref
from .fused_gru import ref as gru_ref


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


def gru_cell_pair(p_f, p_l, x_f, h_f, x_l, h_l):
    """Advance the flow GRU and the link GRU of one stage together
    (params {"wi","wh","bi","bh"} in the repro layout)."""
    if _on_cpu(h_f):
        return gru_ref.gru_pair_ref(p_f, p_l, x_f, h_f, x_l, h_l)
    from .fused_gru.ops import gru_pair
    return gru_pair(p_f, p_l, x_f, h_f, x_l, h_l)


def gnn_rounds(layers, f, l, edge_f, edge_l, edge_mask, num_links):
    """Multi-round bipartite GraphSAGE (m4's spatial model); f (..., SF, G),
    l (..., num_links, G)."""
    if _on_cpu(f):
        m = bipartite_ref.incidence_from_edges(edge_f, edge_l, edge_mask,
                                               f.shape[-2], num_links)
        return bipartite_ref.bipartite_rounds_matmul(layers, f, l, m)
    from .bipartite.ops import bipartite_rounds
    return bipartite_rounds(layers, f, l, edge_f, edge_l, edge_mask)
