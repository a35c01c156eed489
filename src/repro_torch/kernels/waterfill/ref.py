"""Plain PyTorch versions of the water-filling kernels (`csrc/waterfill.cu`).

`masked_rowmin_ref` is what the standalone row-min kernel computes, with
leading batch axes: per flow, the min of `share` over the links it
crosses, or `INF` for a flow that crosses none. A min is exact, so the
kernel equals it bitwise (as `repro.kernels.waterfill.ref`).

`waterfill_event_ref` is what the per-event kernel computes: one
flowSim event's whole progressive water-filling (`_waterfill_masked` of
`repro.core.flowsim_fast`) over a dense (B, N, L) incidence, up to
`MAX_ROUNDS` rounds. It is the CPU path of
`repro_torch.kernels.dispatch.waterfill_event` and the kernel's oracle on
the card. The two link sums (unfrozen flows per link, rate in use per
link) are taken in float64 and rounded once to float32: the reference
leaves their summation order to XLA, and an exact sum makes every order
agree, so the kernel (which sums in its own fixed order) equals this
version bitwise and a tie in the freeze test cannot break two ways.

`waterfill` is `waterfill_jnp` (with its `has_links` mask and an early
exit); only tests use it.
"""
from __future__ import annotations

import torch

# a plain float, as in the JAX package; float32(3.4e38) is finite, and the
# flowSim round freezes a flow with no links at exactly this rate
INF = 3.4e38
# the share of a link with no unfrozen flow, and theta's value for a
# frozen flow (the reference's BIG)
BIG = 1e30
MAX_ROUNDS = 32
# the reference's tie test `f_share <= theta * (1 + 1e-9)` runs in
# float32, where 1 + 1e-9 rounds to 1: it is an equality test, kept as is
TIE = 1 + 1e-9


def masked_rowmin_ref(a, share):
    """a: (..., F, L) 0/1 incidence; share: (..., L). Returns (..., F)."""
    return torch.where(a > 0, share[..., None, :], INF).amin(-1)


def waterfill_round_ref(a, cap, rates, frozen):
    """One progressive-filling round. a: (B, N, L) 0/1 incidence (float64
    saves a cast per round; float32 works too); cap: (B, L) float32;
    rates: (B, N) float32; frozen: (B, N) bool. Returns (rates, frozen)."""
    unfrozen = ~frozen
    # (B, 2, N) @ (B, N, L): flows per link, rate in use per link (exact)
    lhs = torch.stack([unfrozen, frozen], 1).to(torch.float64)
    lhs[:, 1] *= rates
    n_l, used = torch.bmm(lhs, a.to(torch.float64)).to(torch.float32) \
        .unbind(1)
    avail = torch.clamp_min(cap - used, 0.0)
    share = torch.where(n_l > 0, avail / n_l.clamp_min(1.0), BIG)
    f_share = masked_rowmin_ref(a, share)
    theta = torch.where(unfrozen, f_share, BIG).amin(-1, keepdim=True)
    newly = unfrozen & (f_share <= theta * TIE)
    return torch.where(newly, f_share, rates), frozen | newly


def waterfill_event_ref(a, cap, active, *, max_rounds=MAX_ROUNDS):
    """Max-min rates of the active flows of B scenarios, with no host
    sync. a: (B, N, L) 0/1 incidence; cap: (B, L) float32; active: (B, N)
    bool. Returns (rates, rounds, capped): rates (B, N) float32, zero for
    inactive flows and for flows left unfrozen after `max_rounds`;
    rounds (B,) int32, the rounds the reference's `while_loop` runs; and
    capped (B,) bool, whether `max_rounds` left some flow unfrozen.

    Exactly `max_rounds` rounds run: once every flow is frozen a round
    changes nothing, so the fixed count equals the reference's early exit
    (and the kernel's)."""
    rates = torch.zeros(active.shape, dtype=torch.float32,
                        device=active.device)
    frozen = ~active
    rounds = torch.zeros(active.shape[0], dtype=torch.int32,
                         device=active.device)
    for _ in range(max_rounds):
        rounds += ~frozen.all(-1)
        rates, frozen = waterfill_round_ref(a, cap, rates, frozen)
    return torch.where(active, rates, 0.0), rounds, ~frozen.all(-1)


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
