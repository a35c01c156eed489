"""Plain PyTorch versions of the water-filling row-min kernel, and a full
water-filling loop, as `repro.kernels.waterfill.ref`.

`masked_rowmin_ref` is what `csrc/waterfill.cu` computes, with leading
batch axes: per flow, the min of `share` over the links it crosses, or
`INF` for a flow that crosses none. A min is exact, so the kernel equals
it bitwise. `waterfill` is `waterfill_jnp` (with its `has_links` mask and
an early exit); only tests use it.
"""
from __future__ import annotations

import torch

# a plain float, as in the JAX package; float32(3.4e38) is finite, and the
# flowSim round freezes a flow with no links at exactly this rate
INF = 3.4e38


def masked_rowmin_ref(a, share):
    """a: (..., F, L) 0/1 incidence; share: (..., L). Returns (..., F)."""
    return torch.where(a > 0, share[..., None, :], INF).amin(-1)


def waterfill(a, cap, *, max_rounds=64):
    """Progressive-filling max-min rates; a: (F, L) 0/1 incidence, cap:
    (L,), both float32. Returns rates (F,)."""
    has_links = a.sum(1) > 0
    rates = torch.zeros(a.shape[0], dtype=a.dtype, device=a.device)
    frozen = ~has_links
    for _ in range(max_rounds):
        if bool(frozen.all()):
            break
        u = torch.where(frozen, 0.0, 1.0) * has_links
        n_l = u @ a                                   # unfrozen per link
        used = (rates * frozen) @ a
        avail = torch.clamp_min(cap - used, 0.0)
        share = torch.where(n_l > 0, avail / n_l.clamp_min(1.0), INF)
        f_share = masked_rowmin_ref(a, share)
        theta = torch.where(u > 0, f_share, INF).min()
        newly = (u > 0) & (f_share <= theta * (1 + 1e-9))
        rates = torch.where(newly, f_share, rates)
        frozen = frozen | newly | ~has_links
    return rates
