"""Plain PyTorch versions of the bipartite GraphSAGE round, in the two
forms of `repro.kernels.bipartite.ref`:

- the segment-sum oracle (`bipartite_round_ref`, the math of
  `repro.core.model._bipartite_round`): gather the neighbour rows, mask,
  sum them per destination row;
- the incidence-matmul form (`incidence_from_edges` +
  `bipartite_rounds_matmul`): agg_f = M @ l, agg_l = Mᵀ @ f with M the
  (SF, SL) edge-count matrix — the TPU kernel's formulation and the plain
  path that `repro_torch.kernels.dispatch` takes on the CPU.

Every function takes optional leading batch axes: f (..., SF, G),
l (..., SL, G), edge_l / edge_mask (..., E), edge_f (E,) or (..., E).
"""
from __future__ import annotations

import torch


def _batched(f, l, edge_f, edge_l, edge_mask):
    """Flatten the leading axes to one batch axis B."""
    SF, G = f.shape[-2:]
    SL, E = l.shape[-2], edge_l.shape[-1]
    lead = f.shape[:-2]
    B = f.numel() // (SF * G) if SF * G else 0
    return (lead, f.reshape(B, SF, G), l.reshape(B, SL, G),
            edge_f.expand(*lead, E).reshape(B, E), edge_l.reshape(B, E),
            edge_mask.reshape(B, E))


def incidence_from_edges(edge_f, edge_l, edge_mask, SF: int, SL: int):
    """Edge list -> incidence matrix (..., SF, SL) of masked edge counts."""
    lead = edge_l.shape[:-1]
    E = edge_l.shape[-1]
    ef = edge_f.expand(*lead, E).reshape(-1, E)
    el = edge_l.reshape(-1, E)
    m = torch.zeros(el.shape[0], SF * SL, dtype=edge_mask.dtype,
                    device=edge_mask.device)
    m.scatter_add_(1, ef * SL + el, edge_mask.reshape(-1, E))
    return m.reshape(*lead, SF, SL)


def bipartite_round_ref(f, l, edge_f, edge_l, edge_mask, wf, wl, bf, bl):
    """Segment-sum GraphSAGE round. wf/wl: (2G, G); bf/bl: (G,)."""
    lead, f3, l3, ef, el, em = _batched(f, l, edge_f, edge_l, edge_mask)
    B, SF, G = f3.shape
    SL, E = l3.shape[1], el.shape[1]
    idx_f = ef[:, :, None].expand(B, E, G)
    idx_l = el[:, :, None].expand(B, E, G)
    msg_f = torch.gather(f3, 1, idx_f) * em[:, :, None]      # flow -> link
    msg_l = torch.gather(l3, 1, idx_l) * em[:, :, None]      # link -> flow
    agg_l = torch.zeros_like(l3).scatter_add_(1, idx_l, msg_f)
    agg_f = torch.zeros_like(f3).scatter_add_(1, idx_f, msg_l)
    f_new = torch.relu(torch.cat([f3, agg_f], -1) @ wf + bf)
    l_new = torch.relu(torch.cat([l3, agg_l], -1) @ wl + bl)
    return f_new.reshape(*lead, SF, G), l_new.reshape(*lead, SL, G)


def bipartite_rounds_matmul(layers, f, l, m):
    """Rounds in the incidence-matmul form; m: (..., SF, SL)."""
    G = f.shape[-1]
    mt = m.transpose(-1, -2)
    for layer in layers:
        agg_f = m @ l
        agg_l = mt @ f
        wf, bf = layer["wf"]["w"], layer["wf"]["b"]
        wl, bl = layer["wl"]["w"], layer["wl"]["b"]
        f, l = (torch.relu(f @ wf[:G] + agg_f @ wf[G:] + bf),
                torch.relu(l @ wl[:G] + agg_l @ wl[G:] + bl))
    return f, l
