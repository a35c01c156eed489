"""Mixture-of-Experts layer with GShard/Switch-style grouped capacity
dispatch, as `repro.nn.moe`.

Tokens are split into groups of `group_size` (or one group of all N
tokens when N is not a multiple of it); within each group, each expert
accepts at most C tokens (`_capacity`). The top-k choices take their
buffer slots in GShard priority: every k = 0 choice first, then k = 1,
..., in token order within each. Dispatch and combine tensors are dense
one-hots built per k-th choice, the expert FFNs (SwiGLU) one batched
product over the expert axis; an optional shared expert runs on every
token, and the Switch load-balancing loss comes back as `aux`.

`jax.lax.top_k` breaks ties toward the lower index, and `torch.topk`
promises no order among equal values, so the top k are the first k of a
stable descending sort.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..launch import sharding
from .layers import einsum, lecun_normal, linear, linear_init


class MoECfg(NamedTuple):
    d_model: int
    d_ff: int                 # per-expert hidden
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    shared_d_ff: int = 0      # llama4-style always-on shared expert (0 = off)
    group_size: int = 4096


def moe_init(gen: torch.Generator, cfg: MoECfg, *, dtype=torch.float32,
             device=None) -> dict:
    E, D, Fh = cfg.num_experts, cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=device)
    p = {
        "router": linear_init(gen, D, E, bias=False, **kw),
        # SwiGLU experts: gate, up, down
        "wg": lecun_normal(gen, (E, D, Fh), in_axis=1, **kw),
        "wu": lecun_normal(gen, (E, D, Fh), in_axis=1, **kw),
        "wd": lecun_normal(gen, (E, Fh, D), in_axis=1, **kw),
    }
    if cfg.shared_d_ff:
        S = cfg.shared_d_ff
        p["shared"] = {"wg": lecun_normal(gen, (D, S), **kw),
                       "wu": lecun_normal(gen, (D, S), **kw),
                       "wd": lecun_normal(gen, (S, D), **kw)}
    return p


def _capacity(cfg: MoECfg, group: int) -> int:
    c = int(cfg.capacity_factor * group * cfg.top_k / cfg.num_experts)
    return max(4, -(-c // 4) * 4)


def top_k(x: torch.Tensor, k: int):
    """`jax.lax.top_k` over the last axis: the k largest values and their
    indices, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(x: torch.Tensor, n: int, start: int = 0) -> torch.Tensor:
    """`jax.nn.one_hot` in float32 over the classes [start, start + n): a
    value outside them (a token past capacity) gives a row of zeros."""
    return (x[..., None] == torch.arange(start, start + n,
                                         device=x.device)).float()


def _route(cfg: MoECfg, w, xt):
    """The router on groups xt (ng, G, D): each token's top-k weights
    (renormalised) and experts, (ng, G, K), the slot of each choice in its
    expert's buffer in GShard priority (ng, G, K), and the Switch loss's
    two means over the groups and tokens, (E,) each: the router's
    probabilities and the share of choices routed to each expert."""
    ng, G, _ = xt.shape
    E, K = cfg.num_experts, cfg.top_k
    logits = linear({"w": w}, xt).float()                     # (ng, G, E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = top_k(probs, K)                              # (ng, G, K)
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)

    onehot = _one_hot(topi, E)                                # (ng,G,K,E)
    # GShard priority: all k=0 choices first, then k=1, ...; token order
    # inside each k. The position of each (k, g) in its expert's buffer:
    flat = onehot.permute(0, 2, 1, 3).reshape(ng, K * G, E)
    pos = torch.cumsum(flat, dim=1) * flat - 1.0              # (ng,K*G,E)
    pos = pos.reshape(ng, K, G, E).permute(0, 2, 1, 3)        # (ng,G,K,E)
    pos_k = (pos * onehot).sum(-1)                            # (ng, G, K)

    me = probs.mean((0, 1))                                   # (E,)
    ce = onehot.sum(2).mean((0, 1))                           # routed share
    return topv, topi, pos_k, me, ce


def _experts(C: int, e0: int, topv, topi, pos_k, xt, wg, wu, wd):
    """Dispatch xt (ng, G, D) into the buffers of experts e0, e0 + 1, ...
    (as many as `wg` holds), run their FFNs (SwiGLU) and combine: (ng, G,
    D), summed over those experts. Dispatch and combine are dense one-hots
    (ng, G, E, C) built per k-th choice."""
    ng, G, _ = xt.shape
    E = wg.shape[0]
    onehot = _one_hot(topi, E, e0)                            # (ng,G,K,E)
    in_cap = (pos_k < C) & (pos_k >= 0)
    disp = torch.zeros(ng, G, E, C, dtype=xt.dtype, device=xt.device)
    comb = torch.zeros(ng, G, E, C, dtype=torch.float32, device=xt.device)
    for k in range(topi.shape[-1]):
        oc = _one_hot(pos_k[..., k], C) * in_cap[..., k:k + 1]   # (ng,G,C)
        d_k = einsum("age,agc->agec", onehot[:, :, k], oc)
        disp = disp + d_k.to(xt.dtype)
        comb = comb + d_k * topv[..., k][..., None, None]

    # route into per-expert buffers and run the expert FFNs
    buf = einsum("agec,agd->aecd", disp, xt)                  # (ng,E,C,D)
    g = einsum("aecd,edf->aecf", buf, wg.to(xt.dtype))
    u = einsum("aecd,edf->aecf", buf, wu.to(xt.dtype))
    h = F.silu(g) * u
    eout = einsum("aecf,efd->aecd", h, wd.to(xt.dtype))
    return einsum("agec,aecd->agd", comb.to(xt.dtype), eout)


def moe_forward(p, cfg: MoECfg, x):
    """x: (B, S, D) -> (out (B, S, D), aux_loss).

    On DTensors (`sharding.per_shard`) the routing runs on each rank's
    groups, split over the data axes (one group, as at decode, stays
    whole) and the same on every `model` rank; the experts run as heads
    on `model`: each rank builds the dispatch and combine of its own
    experts from the routing's choices and slots, runs them and combines,
    and the output is a partial sum over `model` that the caller's
    `activation` reduces. The dense (ng, G, E, C) one-hots never cross
    ranks. The aux loss is formed from the two means over all groups."""
    B, S, D = x.shape
    N = B * S
    G = cfg.group_size if N % cfg.group_size == 0 else N
    ng = N // G
    E = cfg.num_experts
    C = _capacity(cfg, G)
    xt = x.reshape(ng, G, D)

    topv, topi, pos_k, me, ce = sharding.per_shard(
        lambda w, xt: _route(cfg, w, xt), (p["router"]["w"], xt),
        ((None, None), (0, None)),
        ((0, None),) * 3 + (sharding.MEAN, sharding.MEAN))
    out = sharding.per_shard(
        lambda *a, h0: _experts(C, h0, *a),
        (topv, topi, pos_k, xt, p["wg"], p["wu"], p["wd"]),
        ((0, None),) * 4 + ((None, 0),) * 3, ((0, sharding.SUM),), heads=E)

    if cfg.shared_d_ff:
        sp = p["shared"]
        sh = F.silu(xt @ sp["wg"].to(x.dtype)) * (xt @ sp["wu"].to(x.dtype))
        out = out + sh @ sp["wd"].to(x.dtype)

    # Switch-style load-balancing aux loss
    aux = E * torch.sum(me * ce) / cfg.top_k
    return out.reshape(B, S, D), aux
