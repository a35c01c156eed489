"""m4's neural architecture (§3.2, §4), on nested dicts of tensors.

Four GRUs (GRU-1/GRU-A temporal for flows/links, GRU-2/GRU-B post-GNN),
a GraphSAGE GNN (sum aggregator) on the bipartite flow-link snapshot
graph, and three query MLPs (FCT slowdown, remaining size, queue
length). Defaults follow the paper: 400-d hidden states, 300-d GNN
embeddings, 200-d 2-layer MLPs, 9-d network-config vector input.

The parameter tree is the one of `repro.core.model.init_m4`, so JAX
weights load unchanged (`repro_torch.weights`). The GRU cells and GNN
rounds run through `repro_torch.kernels.dispatch`: the CUDA kernels on a
card, the plain versions on the CPU. `plain=True` takes the plain versions
on any device: the training step passes it, since the kernels define no
backward (the counterpart of the JAX package's `kernel_mode="xla"` in
`repro.core.training`). Every function takes optional leading batch axes
(the scenarios of `run_many`, the sims of a training bucket).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..kernels import dispatch
from ..nn import gru_init, linear, linear_init, mlp, mlp_init


@dataclass(frozen=True)
class M4Config:
    hidden: int = 400
    gnn_dim: int = 300
    mlp_hidden: int = 200
    gnn_layers: int = 3
    snap_flows: int = 64     # SNAP_F
    snap_links: int = 128    # SNAP_L
    max_path: int = 8        # P
    cfg_dim: int = 9
    dense_sldn: bool = True

    @property
    def flow_feat(self):
        return 3  # log size, n_links, log ideal_fct

    @property
    def link_feat(self):
        return 1  # log capacity


def init_m4(gen, cfg: M4Config, device=None) -> dict:
    """Seeded random weights of the JAX package's shapes and distributions.
    `gen` is a `torch.Generator` or an int seed."""
    if isinstance(gen, int):
        gen = torch.Generator().manual_seed(gen)
    H, G, M, C = cfg.hidden, cfg.gnn_dim, cfg.mlp_hidden, cfg.cfg_dim
    kw = {"device": device}
    return {
        "flow_init": mlp_init(gen, [cfg.flow_feat + C, M, H], **kw),
        "link_init": mlp_init(gen, [cfg.link_feat + C, M, H], **kw),
        "gru1": gru_init(gen, 1 + cfg.flow_feat + C, H, **kw),
        "gruA": gru_init(gen, 1 + cfg.link_feat + C, H, **kw),
        "proj_f": linear_init(gen, H, G, **kw),
        "proj_l": linear_init(gen, H, G, **kw),
        "gnn": [{"wf": linear_init(gen, 2 * G, G, **kw),
                 "wl": linear_init(gen, 2 * G, G, **kw)}
                for _ in range(cfg.gnn_layers)],
        "gru2": gru_init(gen, G + C, H, **kw),
        "gruB": gru_init(gen, G + C, H, **kw),
        "mlp_sldn": mlp_init(gen, [H + 1 + C, M, M, 1], **kw),
        "mlp_size": mlp_init(gen, [H, M, M, 1], **kw),
        "mlp_queue": mlp_init(gen, [H, M, M, 1], **kw),
    }


# ---------------------------------------------------------------- features
def time_feat(dt):
    """dt seconds -> bounded feature."""
    return torch.log1p(torch.clamp(dt, min=0.0) / 1e-6) / 10.0


def flow_static_feat(size_bytes, n_links, ideal_fct):
    return torch.stack([
        torch.log1p(size_bytes / 1e3) / 10.0,
        n_links / 8.0,
        torch.log1p(ideal_fct / 1e-6) / 10.0,
    ], dim=-1)


def link_static_feat(capacity):
    return (torch.log1p(capacity / 1e9) / 10.0)[..., None]


def softplus(x):
    """log(1 + e^x) for every x, as jax.nn.softplus (torch's own softplus
    switches to the identity above a threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _with_cfg(x, cfg_vec):
    """Append the config vector (C,) or (B, C) to every row of x."""
    c = cfg_vec.unsqueeze(-2).expand(*x.shape[:-1], cfg_vec.shape[-1])
    return torch.cat([x, c], -1)


# ---------------------------------------------------------------- GNN
def gnn_forward(params, cfg: M4Config, f_h, l_h, edge_f, edge_l, edge_mask,
                *, plain=False):
    """f_h: (..., SNAP_F, H), l_h: (..., SNAP_L, H) -> GNN embeddings."""
    f = torch.relu(linear(params["proj_f"], f_h))
    l = torch.relu(linear(params["proj_l"], l_h))
    return dispatch.gnn_rounds(params["gnn"], f, l, edge_f, edge_l,
                               edge_mask, cfg.snap_links, plain=plain)


# ---------------------------------------------------------------- queries
def predict_sldn(params, flow_h, n_links, cfg_vec):
    """-> FCT slowdown (>= 1)."""
    x = _with_cfg(torch.cat([flow_h, n_links[..., None] / 8.0], -1), cfg_vec)
    return 1.0 + softplus(mlp(params["mlp_sldn"], x)[..., 0])


def predict_size(params, flow_h):
    """-> remaining fraction of flow size in [0, 1]."""
    return torch.sigmoid(mlp(params["mlp_size"], flow_h)[..., 0])


def predict_queue(params, link_h):
    """-> queue length, log1p(bytes/1KB) scale (>= 0)."""
    return softplus(mlp(params["mlp_queue"], link_h)[..., 0])


# ---------------------------------------------------------------- one event
def temporal_update(params, cfg: M4Config, f_h, l_h, dt_f, dt_l,
                    f_feat, l_feat, cfg_vec, *, plain=False):
    """GRU-1 / GRU-A temporal advance of snapshot states."""
    xin_f = _with_cfg(torch.cat([time_feat(dt_f)[..., None], f_feat], -1),
                      cfg_vec)
    xin_l = _with_cfg(torch.cat([time_feat(dt_l)[..., None], l_feat], -1),
                      cfg_vec)
    return dispatch.gru_cell_pair(params["gru1"], params["gruA"],
                                  xin_f, f_h, xin_l, l_h, plain=plain)


def spatial_update(params, cfg: M4Config, f_h, l_h, edge_f, edge_l,
                   edge_mask, cfg_vec, *, plain=False):
    """GNN + GRU-2/GRU-B state refresh."""
    gf, gl = gnn_forward(params, cfg, f_h, l_h, edge_f, edge_l, edge_mask,
                         plain=plain)
    return dispatch.gru_cell_pair(params["gru2"], params["gruB"],
                                  _with_cfg(gf, cfg_vec), f_h,
                                  _with_cfg(gl, cfg_vec), l_h, plain=plain)
