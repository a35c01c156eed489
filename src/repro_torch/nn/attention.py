"""Grouped-query attention with the variants the assigned archs need, as
`repro.nn.attention`:

- GQA/MQA (num_kv_heads <= num_heads), head_dim decoupled from d_model;
- qk-norm (Qwen3), logit softcapping (Gemma2), sliding window (Gemma2
  local layers);
- RoPE / M-RoPE on the positions passed in;
- the full causal path (training, prefill) and the decode path (one new
  token against a KV cache).

The attention is the JAX package's arithmetic, written out: q reshaped to
(B, S, Hkv, group, D), logits in float32 divided by sqrt(D), the tanh
softcap, masking with -1e30 and the softmax in float32, cast to v's
dtype. (`scaled_dot_product_attention` has no softcap, and the JAX
package has no attention kernel.) On DTensors (the dry-run's meshes)
each rank attends over its own rows and heads (`launch.sharding.
per_shard`); `AttnCfg.batch_axes`, JAX's sharding constraint on q/k/v,
then splits the batch over those mesh axes alone. On plain tensors it
is the identity, as it is in JAX without a mesh.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..launch import sharding
from .layers import einsum, linear, linear_init, rmsnorm, rmsnorm_init
from .rope import apply_mrope, apply_rope


class AttnCfg(NamedTuple):
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    logit_softcap: float = 0.0     # 0 disables
    sliding_window: int = 0        # 0 = global
    rope_theta: float = 10000.0
    mrope_sections: tuple = ()     # non-empty enables M-RoPE
    batch_axes: tuple = ()         # JAX's mesh reshard; identity here


def attn_init(gen: torch.Generator, cfg: AttnCfg, *, dtype=torch.float32,
              device=None) -> dict:
    kw = dict(bias=False, dtype=dtype, device=device)
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"q": linear_init(gen, cfg.d_model, H * D, **kw),
         "k": linear_init(gen, cfg.d_model, Hkv * D, **kw),
         "v": linear_init(gen, cfg.d_model, Hkv * D, **kw),
         "o": linear_init(gen, H * D, cfg.d_model, **kw)}
    if cfg.qk_norm:
        p["qn"] = rmsnorm_init(D, dtype=dtype, device=device or gen.device)
        p["kn"] = rmsnorm_init(D, dtype=dtype, device=device or gen.device)
    return p


def _heads(t, H, D):
    """(B, S, H*D) -> (B, S, H, D)."""
    t = sharding.whole_heads(t, H)
    return t.reshape(t.shape[0], t.shape[1], H, D)


def _project_qkv(p, cfg: AttnCfg, x, positions):
    B, S, _ = x.shape
    q = _heads(linear(p["q"], x), cfg.num_heads, cfg.head_dim)
    k = _heads(linear(p["k"], x), cfg.num_kv_heads, cfg.head_dim)
    v = _heads(linear(p["v"], x), cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q, k = rmsnorm(p["qn"], q), rmsnorm(p["kn"], k)
    if cfg.mrope_sections:
        q = apply_mrope(q, positions, cfg.mrope_sections, theta=cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, theta=cfg.rope_theta)
    else:
        q = apply_rope(q, positions, theta=cfg.rope_theta)
        k = apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def _sdpa(cfg: AttnCfg, q, k, v, mask):
    """q: (B,S,Hq,D), k/v: (B,T,Hkv,D), mask: (B,1,S,T) or broadcastable."""
    group = cfg.num_heads // cfg.num_kv_heads
    B, S, Hq, D = q.shape
    qg = q.reshape(B, S, cfg.num_kv_heads, group, D)
    logits = einsum("bskgd,btkd->bkgst", qg, k).float()
    logits = logits / math.sqrt(D)
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    logits = torch.where(mask[:, :, None] if mask.dim() == 4 else mask,
                         logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, Hq * D)


def causal_mask(S: int, T=None, *, sliding_window=0, device=None):
    """(1, 1, S, T) bool: query i (at absolute position i + T - S) sees key
    j <= it, and with a window only the last `sliding_window` of them."""
    T = T or S
    i = torch.arange(S, device=device)[:, None] + (T - S)
    j = torch.arange(T, device=device)[None, :]
    m = j <= i
    if sliding_window > 0:
        m &= j > i - sliding_window
    return m[None, None]


def attn_forward(p, cfg: AttnCfg, x, positions):
    """Training / prefill path. x: (B, S, d_model)."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    mask = causal_mask(x.shape[1], sliding_window=cfg.sliding_window,
                       device=x.device)
    return linear(p["o"], _attend(cfg, q, k, v, mask))


def _attend(cfg: AttnCfg, q, k, v, mask):
    """`_sdpa`, on DTensors by each rank over its own rows and heads
    (`sharding.per_shard`: DTensor cannot shard the products, which
    flatten batch and heads into one dimension). With `cfg.batch_axes`
    the batch goes over those axes and nothing else (the DeepSpeed-Ulysses
    pattern: the S x S logits never cross devices). Otherwise the q heads
    split into n parts where n divides them and the kv heads divide n or
    n them; in the latter case each rank's q heads share one kv head, its
    slice of the replicated k and v."""
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    n = sharding.head_parts(q)
    split = (not cfg.batch_axes and H % n == 0
             and (Hkv % n == 0 or n % Hkv == 0))
    if not split:
        n = 1
    shared = Hkv % n != 0
    local = cfg._replace(num_heads=H // n,
                         num_kv_heads=1 if shared else Hkv // n)

    def attend(q, k, v, mask, h0=0):
        if shared:
            kv = h0 // (H // Hkv)
            k, v = k[:, :, kv:kv + 1], v[:, :, kv:kv + 1]
        return _sdpa(local, q, k, v, mask)

    kv_dims = (0, None) if shared else (0, 2)
    return sharding.per_shard(
        attend, (q, k, v, mask), ((0, 2), kv_dims, kv_dims, (None, None)),
        ((0, 2),), heads=H if split else None, over=cfg.batch_axes)


def _write(k_cache, v_cache, k, v, cache_len):
    """New caches with the token's k and v (B,1,Hkv,D) written at slot
    `min(max(cache_len, 0), T - 1)`: JAX's `dynamic_update_slice` clamps
    its start so the update fits. On DTensors each rank writes its own
    slice of T (the caches' time axis is split over `model`,
    `decode_state_spec`; `per_shard` with T in the role of heads hands
    each rank its first slot as `h0`): DTensor has no rule for
    `index_copy` in some torch versions."""
    T = k_cache.shape[1]

    def write(kc, vc, k, v, t, h0=0):
        hit = torch.arange(h0, h0 + kc.shape[1], device=kc.device) \
            == t.clamp(0, T - 1)
        hit = hit[None, :, None, None]
        return torch.where(hit, k, kc), torch.where(hit, v, vc)

    return sharding.per_shard(
        write, (k_cache, v_cache, k, v, cache_len),
        ((0, 1), (0, 1), (0, None), (0, None), (None, None)),
        ((0, 1), (0, 1)), heads=T)


def attn_decode(p, cfg: AttnCfg, x, positions, k_cache, v_cache, cache_len):
    """One-token decode. x: (B,1,d); caches: (B,T,Hkv,D); cache_len: a
    0-d integer tensor (or int), the new token's index.

    Returns (out, new_k_cache, new_v_cache): new tensors, the token's k
    and v written by `_write` (past T into the last slot); the caches
    passed in are not written. The mask keeps the unclamped `cache_len`:
    past T it admits every slot, as JAX's does."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    T = k_cache.shape[1]
    cache_len = torch.as_tensor(cache_len, device=x.device)
    k_cache, v_cache = _write(k_cache, v_cache, k.to(k_cache.dtype),
                              v.to(v_cache.dtype), cache_len)
    j = torch.arange(T, device=x.device)[None, None, None, :]
    mask = j <= cache_len                          # (1,1,1,T)
    if cfg.sliding_window > 0:
        mask &= j > cache_len - cfg.sliding_window
    out = _attend(cfg, q, k_cache, v_cache, mask)
    return linear(p["o"], out), k_cache, v_cache
