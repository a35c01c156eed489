"""Hand-written AdamW over trees of tensors, in the arithmetic of
`repro.optim.adamw`: the update is

    p - lr * (mhat / (sqrt(vhat) + eps) + weight_decay * p)

with b2 = 0.95 by default and `step` an int32 scalar tensor, so one step
from the same weights and gradients matches the JAX package to float32
rounding. (`torch.optim.AdamW` decays the weights before the Adam step and
gives other numbers.) The dtypes are JAX's too: a bfloat16 weight leaves
its first step as float32, its moments their second. The functions build
new tensors and never write into their arguments; call them without
autograd recording.
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


def global_norm(grads):
    """The global L2 norm of a tree of gradients: the leaves' float32 sums
    of squares added up in flattening order, as in JAX."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for _, g in tree_leaves(grads)))


def scale_by_norm(grads, gn, max_norm):
    """The gradients scaled so that a tree of global norm `gn` would have
    norm at most `max_norm`, each leaf in its own dtype."""
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads)


def clip_by_global_norm(grads, max_norm):
    """Scale the gradients so that their global L2 norm is at most
    `max_norm`; returns (grads, norm before clipping)."""
    gn = global_norm(grads)
    return scale_by_norm(grads, gn, max_norm), gn


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
        mhat = _widened(m_, bc1) / bc1
        vhat = _widened(v_, bc2) / bc2
        return p - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p)

    return tree_map(upd, params, m, v), {"m": m, "v": v, "step": step}


def _widened(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """`x` in the dtype JAX gives `x / s` for the float32 0-d tensor `s`:
    JAX promotes a bfloat16 array against it to float32, where torch keeps
    the dimensioned tensor's dtype. The rest of the update then runs in
    float32 too, so a bfloat16 weight leaves its first step as float32, as
    in JAX."""
    return x.to(torch.promote_types(x.dtype, s.dtype))
