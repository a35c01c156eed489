"""Mamba2 (SSD, state-space duality) block, chunk-parallel, as
`repro.nn.ssm`.

The chunked algorithm follows the SSD paper (arXiv:2405.21060, Listing
1): intra-chunk contributions are dense masked products, the inter-chunk
recurrence a loop over the chunks' states (JAX's `lax.scan`), its end
states accumulated in float32. Decode is the O(1) recurrent step with a
conv ring buffer and the SSM state.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..launch import sharding
from .layers import (einsum, lecun_normal, linear, linear_init, rmsnorm,
                     rmsnorm_init)


class SSMCfg(NamedTuple):
    d_model: int
    d_inner: int          # expand * d_model
    d_state: int
    head_dim: int = 64
    d_conv: int = 4
    chunk: int = 128

    @property
    def nheads(self):
        return self.d_inner // self.head_dim


def ssm_init(gen: torch.Generator, cfg: SSMCfg, *, dtype=torch.float32,
             device=None) -> dict:
    dev = device or gen.device
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.d_state + cfg.nheads
    conv_dim = cfg.d_inner + 2 * cfg.d_state
    H = cfg.nheads
    return {
        "in_proj": linear_init(gen, cfg.d_model, d_in_proj, bias=False,
                               dtype=dtype, device=device),
        "conv_w": lecun_normal(gen, (cfg.d_conv, conv_dim), in_axis=0,
                               dtype=dtype, device=device),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=dev),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=dev)).to(dtype),
        "D": torch.ones(H, dtype=dtype, device=dev),
        "dt_bias": torch.zeros(H, dtype=dtype, device=dev),
        "norm": rmsnorm_init(cfg.d_inner, dtype=dtype, device=dev),
        "out_proj": linear_init(gen, cfg.d_inner, cfg.d_model, bias=False,
                                dtype=dtype, device=device),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., q) -> (..., q, q) lower-triangular segment sums."""
    q = x.shape[-1]
    xc = torch.cumsum(x, dim=-1)
    ss = xc[..., :, None] - xc[..., None, :]
    mask = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    return torch.where(mask, ss, -math.inf)


def _causal_conv(x, w, b):
    """x: (B, S, C); w: (K, C) depthwise causal conv. On DTensors each
    rank convolves its own rows (`sharding.per_shard`: DTensor's rule for
    the padding fails in some torch versions); the channels stay whole,
    as the input's are after the projection's split and concatenation,
    so only the (K, C) weight is gathered."""
    def conv(x, w, b):
        K, S = w.shape[0], x.shape[1]
        pad = F.pad(x, (0, 0, K - 1, 0))
        return sum(pad[:, i:i + S, :] * w[i] for i in range(K)) + b

    return sharding.per_shard(conv, (x, w, b),
                              ((0, None), (None, None), (None, None)),
                              ((0, None),))


def _ssd_chunked(xh, dtA, Bm, Cm, chunk: int, h0=None):
    """SSD scan. xh: (B,S,H,P) (already dt-scaled), dtA: (B,S,H) log-decay,
    Bm/Cm: (B,S,N). Returns (y: (B,S,H,P), final_state: (B,H,P,N))."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    assert S % chunk == 0, (S, chunk)
    c = S // chunk
    xc = xh.reshape(Bsz, c, chunk, H, P)
    Ac = dtA.reshape(Bsz, c, chunk, H).permute(0, 3, 1, 2)    # (B,H,c,q)
    Bc = Bm.reshape(Bsz, c, chunk, N)
    Cc = Cm.reshape(Bsz, c, chunk, N)

    A_cs = torch.cumsum(Ac, dim=-1)                           # (B,H,c,q)
    L = torch.exp(_segsum(Ac))                                # (B,H,c,q,q)
    # intra-chunk
    y_diag = einsum("bcln,bcsn,bhcls,bcshp->bclhp", Cc, Bc, L, xc)
    # per-chunk end states (accumulated in float32 for bf16 inputs)
    decay_states = torch.exp(A_cs[..., -1:] - A_cs)           # (B,H,c,q)
    states = einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states,
                    xc).float()
    # inter-chunk recurrence: h_{k+1} = exp(sum A_k) h_k + states_k
    chunk_decay = torch.exp(A_cs[..., -1])                    # (B,H,c)
    h = torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=xh.device) \
        if h0 is None else h0.float()
    h_prevs = []
    for k in range(c):
        h_prevs.append(h)
        h = h * chunk_decay[:, :, k, None, None] + states[:, k]
    h_prevs = torch.stack(h_prevs, dim=1)                     # (B,c,H,P,N)
    # inter-chunk contribution
    state_decay = torch.exp(A_cs)                             # (B,H,c,q)
    y_off = einsum("bcln,bchpn,bhcl->bclhp", Cc.float(), h_prevs,
                   state_decay)
    y = (y_diag.float() + y_off).reshape(Bsz, S, H, P)
    return y.to(xh.dtype), h.to(xh.dtype)


def _ssd(xh, dtA, Bm, Cm, chunk: int):
    """`_ssd_chunked`, on DTensors by each rank over its own rows and
    heads (`sharding.per_shard`: DTensor cannot shard the scan's products,
    which flatten batch and heads into one dimension); B and C, one group
    shared by the heads, come whole to each rank."""
    return sharding.per_shard(
        lambda xh, dtA, Bm, Cm, h0: _ssd_chunked(xh, dtA, Bm, Cm, chunk),
        (xh, dtA, Bm, Cm), ((0, 2), (0, 2), (0, None), (0, None)),
        ((0, 2), (0, 1)), heads=xh.shape[2])


def _split_in_proj(cfg: SSMCfg, zxbcdt):
    """z, x, B, C, dt of the input projection."""
    di, ds = cfg.d_inner, cfg.d_state
    return torch.split(zxbcdt, [di, di, ds, ds, cfg.nheads], dim=-1)


def ssm_forward(p, cfg: SSMCfg, x):
    """Training / prefill path. x: (B, S, d_model) -> (B, S, d_model)."""
    B_, S, _ = x.shape
    z, xr, Bm, Cm, dt = _split_in_proj(cfg, linear(p["in_proj"], x))
    xbc = torch.cat([xr, Bm, Cm], dim=-1)
    xbc = F.silu(_causal_conv(xbc, p["conv_w"].to(x.dtype),
                              p["conv_b"].to(x.dtype)))
    xr, Bm, Cm = torch.split(xbc, [cfg.d_inner, cfg.d_state, cfg.d_state],
                             dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())       # (B,S,H)
    A = -torch.exp(p["A_log"].float())                        # (H,)
    dtA = dt * A                                              # log-decay
    xh = xr.reshape(B_, S, cfg.nheads, cfg.head_dim)
    xh_dt = xh * dt[..., None].to(x.dtype)
    y, _ = _ssd(xh_dt, dtA, Bm, Cm, cfg.chunk)
    y = y + xh * p["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(B_, S, cfg.d_inner)
    y = rmsnorm(p["norm"], y * F.silu(z))
    return linear(p["out_proj"], y)


def ssm_decode(p, cfg: SSMCfg, x, conv_state, ssm_state):
    """One-token decode. x: (B,1,d_model). conv_state: (B, K-1, conv_dim);
    ssm_state: (B, H, P, N). Returns (y, conv_state, ssm_state), new
    tensors."""
    B_ = x.shape[0]
    z, xr, Bm, Cm, dt = _split_in_proj(cfg, linear(p["in_proj"], x)[:, 0])
    xbc = torch.cat([xr, Bm, Cm], dim=-1)                     # (B, conv)
    window = torch.cat([conv_state, xbc[:, None]], dim=1)     # (B, K, C)
    conv_state = window[:, 1:]
    w = p["conv_w"].to(x.dtype)
    xbc = F.silu(einsum("bkc,kc->bc", window, w) + p["conv_b"].to(x.dtype))
    xr, Bm, Cm = torch.split(xbc, [cfg.d_inner, cfg.d_state, cfg.d_state],
                             dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())       # (B,H)
    A = -torch.exp(p["A_log"].float())
    da = torch.exp(dt * A)                                    # (B,H)
    xh = xr.reshape(B_, cfg.nheads, cfg.head_dim)
    upd = einsum("bh,bhp,bn->bhpn", dt.to(x.dtype), xh, Bm)
    ssm_state = ssm_state * da[..., None, None].to(x.dtype) + upd
    y = einsum("bhpn,bn->bhp", ssm_state, Cm)
    y = y + xh * p["D"].to(x.dtype)[None, :, None]
    y = y.reshape(B_, 1, cfg.d_inner)
    y = rmsnorm(p["norm"], y * F.silu(z[:, None]))
    return linear(p["out_proj"], y), conv_state, ssm_state
