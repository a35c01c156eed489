"""Hand-written AdamW over trees of tensors, in the arithmetic of
`repro.optim.adamw`: the update is

    p - lr * (mhat / (sqrt(vhat) + eps) + weight_decay * p)

with b2 = 0.95 by default and `step` an int32 scalar tensor, so one step
from the same weights and gradients matches the JAX package to float32
rounding. (`torch.optim.AdamW` decays the weights before the Adam step and
gives other numbers.) The functions build new tensors and never write
into their arguments; call them without autograd recording.
"""
from __future__ import annotations

import torch

from ..weights import tree_leaves, tree_map


def adamw_init(params) -> dict:
    def zeros(tree):
        return tree_map(torch.zeros_like, tree)
    step = torch.zeros((), dtype=torch.int32,
                       device=next(tree_leaves(params))[1].device)
    return {"m": zeros(params), "v": zeros(params), "step": step}


def clip_by_global_norm(grads, max_norm):
    """Scale the gradients so that their global L2 norm is at most
    `max_norm`; returns (grads, norm before clipping). The leaves' sums
    of squares add up in flattening order, as in JAX."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for _, g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gn


def adamw_update(params, grads, state, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.0):
    """One AdamW step; `lr` a float or a float32 scalar tensor. Returns
    (new params, new state)."""
    step = state["step"] + 1
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g),
                 state["v"], grads)
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, m_, v_):
        mhat = m_ / bc1
        vhat = v_ / bc2
        return p - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p)

    return tree_map(upd, params, m, v), {"m": m, "v": v, "step": step}
