"""Composable decoder LM covering all 10 assigned architectures, as
`repro.models.lm`.

One `ArchCfg`-driven model with four structural families:
  dense   — gemma2-9b, yi-34b, qwen3-14b, gemma-7b, qwen2-vl-7b, musicgen-medium
  moe     — moonshot-v1-16b-a3b, llama4-scout-17b-a16e
  ssm     — mamba2-1.3b
  hybrid  — zamba2-2.7b (mamba2 backbone + ONE shared attention block applied
            every `hybrid_attn_every` layers: shared weights, a KV cache per
            site)

The parameter tree is the JAX package's: one tensor per leaf with a
leading layer axis (zamba2's SSM blocks doubly stacked, (groups, every,
...)), so trees, `tree_digest` and checkpoints map one to one. JAX's
`lax.scan` over the layers is a loop over that axis; with `remat` (the
default) and autograd on, each layer's body runs under
`torch.utils.checkpoint` (`use_reentrant=False`), JAX's `jax.checkpoint`.
`unroll` (a roofline knob of the JAX package) changes nothing here, and
`comm_barriers` (an XLA optimization barrier) is the identity.

Entry points run on the device of the parameters; `init_params` draws
them from a `torch.Generator` on its device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..launch.sharding import SUM, activation, per_shard, reduced
from ..nn import (AttnCfg, MoECfg, SSMCfg, attn_decode, attn_forward,
                  attn_init, embedding, embedding_init, lecun_normal, linear,
                  linear_init, moe_forward, moe_init, rmsnorm, rmsnorm_init,
                  ssm_decode, ssm_forward, ssm_init)
from ..weights import tree_leaves, tree_map
from .arch import ArchCfg


# ------------------------------------------------------------------ cfg maps
def _attn_cfg(cfg: ArchCfg, *, local: bool) -> AttnCfg:
    return AttnCfg(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        qk_norm=cfg.qk_norm, logit_softcap=cfg.attn_softcap,
        sliding_window=cfg.sliding_window if local else 0,
        rope_theta=cfg.rope_theta, mrope_sections=cfg.mrope_sections,
        batch_axes=cfg.attn_batch_axes)


def _moe_cfg(cfg: ArchCfg) -> MoECfg:
    return MoECfg(d_model=cfg.d_model, d_ff=cfg.d_ff,
                  num_experts=cfg.num_experts, top_k=cfg.top_k,
                  shared_d_ff=cfg.moe_shared_d_ff)


def _ssm_cfg(cfg: ArchCfg) -> SSMCfg:
    return SSMCfg(d_model=cfg.d_model, d_inner=cfg.d_inner,
                  d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
                  chunk=cfg.ssm_chunk)


# ------------------------------------------------------------------ blocks
def _ffn_init(gen, cfg: ArchCfg, **kw):
    D, Fh = cfg.d_model, cfg.d_ff
    return {"wg": lecun_normal(gen, (D, Fh), **kw),
            "wu": lecun_normal(gen, (D, Fh), **kw),
            "wd": lecun_normal(gen, (Fh, D), **kw)}


def _ffn(p, cfg: ArchCfg, x):
    # jax.nn.gelu's default is the tanh approximation
    act = (lambda v: F.gelu(v, approximate="tanh")) if cfg.act == "gelu" \
        else F.silu
    g = act(x @ p["wg"].to(x.dtype))
    return (g * (x @ p["wu"].to(x.dtype))) @ p["wd"].to(x.dtype)


def _attn_block_init(gen, cfg: ArchCfg, *, local: bool, **kw):
    p = {"ln1": rmsnorm_init(cfg.d_model, **kw),
         "attn": attn_init(gen, _attn_cfg(cfg, local=local), **kw),
         "ln2": rmsnorm_init(cfg.d_model, **kw)}
    if cfg.moe:
        p["moe"] = moe_init(gen, _moe_cfg(cfg), **kw)
    else:
        p["ffn"] = _ffn_init(gen, cfg, **kw)
    if cfg.sandwich_norm:
        p["ln1p"] = rmsnorm_init(cfg.d_model, **kw)
        p["ln2p"] = rmsnorm_init(cfg.d_model, **kw)
    return p


def _attn_block(p, cfg: ArchCfg, x, positions, *, local: bool):
    a = activation(attn_forward(p["attn"], _attn_cfg(cfg, local=local),
                                    rmsnorm(p["ln1"], x), positions))
    if cfg.sandwich_norm:
        a = rmsnorm(p["ln1p"], a)
    x = x + a
    h = rmsnorm(p["ln2"], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.moe:
        f, aux = moe_forward(p["moe"], _moe_cfg(cfg), h)
    else:
        f = _ffn(p["ffn"], cfg, h)
    f = activation(f)
    if cfg.sandwich_norm:
        f = rmsnorm(p["ln2p"], f)
    return x + f, aux


def _attn_block_decode(p, cfg: ArchCfg, x, positions, kc, vc, cache_len, *,
                       local: bool):
    a, kc, vc = attn_decode(p["attn"], _attn_cfg(cfg, local=local),
                            rmsnorm(p["ln1"], x), positions, kc, vc,
                            cache_len)
    a = activation(a)
    if cfg.sandwich_norm:
        a = rmsnorm(p["ln1p"], a)
    x = x + a
    h = rmsnorm(p["ln2"], x)
    if cfg.moe:
        f, _ = moe_forward(p["moe"], _moe_cfg(cfg), h)
    else:
        f = _ffn(p["ffn"], cfg, h)
    f = activation(f)
    if cfg.sandwich_norm:
        f = rmsnorm(p["ln2p"], f)
    return x + f, kc, vc


def _ssm_block_init(gen, cfg: ArchCfg, **kw):
    return {"ln": rmsnorm_init(cfg.d_model, **kw),
            "ssm": ssm_init(gen, _ssm_cfg(cfg), **kw)}


def _ssm_block(p, cfg: ArchCfg, x):
    return x + activation(ssm_forward(p["ssm"], _ssm_cfg(cfg),
                                          rmsnorm(p["ln"], x)))


def _ssm_block_decode(p, cfg: ArchCfg, x, conv_s, ssm_s):
    y, conv_s, ssm_s = ssm_decode(p["ssm"], _ssm_cfg(cfg),
                                  rmsnorm(p["ln"], x), conv_s, ssm_s)
    return x + activation(y), conv_s, ssm_s


# ------------------------------------------------------------------ init
def _stacked(trees):
    """Per-layer trees -> one tree of leaves with a leading layer axis."""
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def _layer(tree, i):
    return tree_map(lambda a: a[i], tree)


def _depth(tree) -> int:
    """The length of the leading (layer) axis of a stacked tree."""
    return next(tree_leaves(tree))[1].shape[0]


def init_params(gen: torch.Generator, cfg: ArchCfg, *, device=None) -> dict:
    """The LM's parameters in `cfg.dtype`, drawn from `gen` on its device
    and placed on `device` (default: the generator's). With
    `device="meta"` nothing is drawn: shapes and dtypes only."""
    kw = dict(dtype=cfg.dtype, device=device or gen.device)
    params = {"final_norm": rmsnorm_init(cfg.d_model, **kw),
              "embed": embedding_init(gen, cfg.padded_vocab, cfg.d_model,
                                      **kw)}
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(gen, cfg.d_model, cfg.padded_vocab,
                                        bias=False, **kw)
    if cfg.family in ("dense", "moe"):
        if cfg.local_global:
            assert cfg.num_layers % 2 == 0
            params["blocks"] = _stacked([
                {"local": _attn_block_init(gen, cfg, local=True, **kw),
                 "global": _attn_block_init(gen, cfg, local=False, **kw)}
                for _ in range(cfg.num_layers // 2)])
        else:
            params["blocks"] = _stacked([
                _attn_block_init(gen, cfg, local=False, **kw)
                for _ in range(cfg.num_layers)])
    elif cfg.family == "ssm":
        params["blocks"] = _stacked([_ssm_block_init(gen, cfg, **kw)
                                     for _ in range(cfg.num_layers)])
    elif cfg.family == "hybrid":
        E = cfg.hybrid_attn_every
        assert cfg.num_layers % E == 0
        params["blocks"] = _stacked([
            _stacked([_ssm_block_init(gen, cfg, **kw) for _ in range(E)])
            for _ in range(cfg.num_layers // E)])
        params["shared_attn"] = _attn_block_init(gen, cfg, local=False,
                                                 **kw)
    else:
        raise ValueError(cfg.family)
    return params


# ------------------------------------------------------------------ forward
def _embed_in(params, cfg: ArchCfg, batch):
    if cfg.frontend != "none":
        x = batch["embeds"]            # stub frontend supplies embeddings
    else:
        x = embedding(params["embed"], batch["tokens"], dtype=cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype,
                           device=x.device)
    return x


def _logits(params, cfg: ArchCfg, x):
    x = rmsnorm(params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].to(x.dtype).T
    else:
        logits = linear(params["lm_head"], x)
    if cfg.final_softcap > 0:
        c = cfg.final_softcap
        logits = c * torch.tanh(logits.float() / c).to(logits.dtype)
    return logits


def _layers(body, x, stacked, *, remat: bool):
    """JAX's `lax.scan` of `body(x, layer) -> (x, aux)` over the leading
    axis of `stacked`; returns (x, the per-layer aux stacked). With
    `remat` and autograd on, each layer recomputes its activations in the
    backward pass."""
    if remat and torch.is_grad_enabled():
        inner = body

        def body(x, bp):
            return checkpoint(inner, x, bp, use_reentrant=False)
    n = _depth(stacked)
    auxs = []
    for i in range(n):
        x, aux = body(x, _layer(stacked, i))
        x = activation(x)
        auxs.append(aux)
    return x, torch.stack(auxs)


def backbone(params, cfg: ArchCfg, batch, *, remat=True, unroll=False):
    """Full-sequence backbone. Returns (hidden (B,S,D), aux_loss)."""
    x = activation(_embed_in(params, cfg, batch))
    B, S, _ = x.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
        if cfg.mrope_sections:
            positions = positions[None].expand(3, B, S)

    if cfg.family in ("dense", "moe"):
        if cfg.local_global:
            def body(x, bp):
                x, a1 = _attn_block(bp["local"], cfg, x, positions,
                                    local=True)
                x, a2 = _attn_block(bp["global"], cfg, x, positions,
                                    local=False)
                return x, a1 + a2
        else:
            def body(x, bp):
                return _attn_block(bp, cfg, x, positions, local=False)
    elif cfg.family == "ssm":
        def body(x, bp):
            return _ssm_block(bp, cfg, x), torch.zeros(
                (), dtype=torch.float32, device=x.device)
    else:  # hybrid
        shared = params["shared_attn"]

        def body(x, gp):
            for e in range(cfg.hybrid_attn_every):
                x = _ssm_block(_layer(gp, e), cfg, x)
            return _attn_block(shared, cfg, x, positions, local=False)
    x, auxs = _layers(body, x, params["blocks"], remat=remat)
    return x, auxs.sum()


def forward(params, cfg: ArchCfg, batch, *, remat=True, unroll=False):
    """Full-sequence forward. Returns (logits, aux_loss)."""
    x, aux = backbone(params, cfg, batch, remat=remat, unroll=unroll)
    return _logits(params, cfg, x), aux


def prefill_step(params, cfg: ArchCfg, batch, *, unroll=False):
    """Inference prefill: run the backbone, project only the last position
    (the (B,S,V) logits tensor is never materialized)."""
    x, _ = backbone(params, cfg, batch, remat=False, unroll=unroll)
    return _logits(params, cfg, x[:, -1:])[:, 0]


def _sharded_nll(logits, labels):
    """The JAX package's vocab-shard-local cross-entropy: every reduction
    over the vocab axis gives (B, S)-sized results; `lmax` cancels in the
    nll and carries no gradient. On DTensors each rank reduces its own
    slice of the vocab (`per_shard`, the vocab in the role of heads on
    `model`), and the two sums are summed over `model` before the log:
    DTensor left to itself shards the logits' gradient along the tokens
    on a 2x16x16 mesh, which the lm head's weight gradient cannot take."""
    V = logits.shape[-1]
    lmax = logits.detach().amax(-1, keepdim=True)

    def sums(logits, lmax, labels, h0):
        shifted = (logits - lmax).float()
        sel = torch.arange(h0, h0 + logits.shape[-1], dtype=torch.int32,
                           device=logits.device)[None, None, :] \
            == labels[..., None]
        return (torch.exp(shifted).sum(-1),
                torch.where(sel, shifted, 0.0).sum(-1))

    sumexp, label_logit = per_shard(
        sums, (logits, lmax, labels), ((0, 2), (0, None), (0, None)),
        ((0, SUM), (0, SUM)), heads=V)
    return torch.log(reduced(sumexp)) - label_logit


def loss_fn(params, cfg: ArchCfg, batch, *, unroll=False):
    logits, aux = forward(params, cfg, batch, unroll=unroll)
    nll = _sharded_nll(logits, batch["labels"])
    mask = batch.get("mask")
    if mask is None:
        loss = nll.mean()
    else:
        loss = (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return loss + 0.01 * aux, {"nll": loss, "aux": aux}


# ------------------------------------------------------------------ decode
def init_decode_state(cfg: ArchCfg, batch_size: int, max_len: int,
                      dtype=None, *, device=None) -> dict:
    """KV caches / SSM states for serve_step, as zeros (`device="meta"`
    allocates nothing)."""
    dtype = dtype or cfg.dtype
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype,  # noqa: E731
                                       device=device)
    st = {"cache_len": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.family in ("dense", "moe"):
        shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads,
                 cfg.head_dim)
        st["k"], st["v"] = zeros(*shape), zeros(*shape)
        return st
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    H = cfg.d_inner // cfg.ssm_head_dim
    if cfg.family == "ssm":
        st["conv"] = zeros(cfg.num_layers, batch_size, 3, conv_dim)
        st["ssm"] = zeros(cfg.num_layers, batch_size, H, cfg.ssm_head_dim,
                          cfg.ssm_state)
        return st
    E = cfg.hybrid_attn_every                          # hybrid
    G = cfg.num_layers // E
    st["conv"] = zeros(G, E, batch_size, 3, conv_dim)
    st["ssm"] = zeros(G, E, batch_size, H, cfg.ssm_head_dim, cfg.ssm_state)
    st["k"] = zeros(G, batch_size, max_len, cfg.num_kv_heads, cfg.head_dim)
    st["v"] = zeros(G, batch_size, max_len, cfg.num_kv_heads, cfg.head_dim)
    return st


def _layers_decode(body, x, xs):
    """JAX's `lax.scan` of `body(x, per-layer xs) -> (x, per-layer ys)`
    over the leading axis of every tree in `xs`; returns (x, the ys
    stacked)."""
    n = _depth(xs[-1])
    ys = []
    for i in range(n):
        x, y = body(x, [_layer(t, i) for t in xs])
        x = activation(x)
        ys.append(y)
    return x, [torch.stack(col) for col in zip(*ys)]


def serve_step(params, cfg: ArchCfg, state, batch, *, unroll=False):
    """One decode step: batch has tokens (B,1) (or embeds (B,1,D)).
    Returns (state, logits (B, vocab)): the dict `state` with its entries
    replaced by new tensors, as the JAX package does."""
    x = activation(_embed_in(params, cfg, batch))
    B = x.shape[0]
    t = state["cache_len"]
    positions = t.to(torch.int32).reshape(1, 1).expand(B, 1)
    if cfg.mrope_sections:
        positions = positions[None].expand(3, B, 1)

    if cfg.family in ("dense", "moe"):
        if cfg.local_global:
            def body(x, xs):
                bp, kc2, vc2 = xs
                x, k0, v0 = _attn_block_decode(bp["local"], cfg, x,
                                               positions, kc2[0], vc2[0], t,
                                               local=True)
                x, k1, v1 = _attn_block_decode(bp["global"], cfg, x,
                                               positions, kc2[1], vc2[1], t,
                                               local=False)
                return x, (torch.stack([k0, k1]), torch.stack([v0, v1]))
            P = cfg.num_layers // 2
            kc = state["k"].reshape((P, 2) + state["k"].shape[1:])
            vc = state["v"].reshape((P, 2) + state["v"].shape[1:])
            x, (nk, nv) = _layers_decode(body, x, [params["blocks"], kc, vc])
            state["k"] = nk.reshape(state["k"].shape)
            state["v"] = nv.reshape(state["v"].shape)
        else:
            def body(x, xs):
                bp, kc, vc = xs
                x, kc, vc = _attn_block_decode(bp, cfg, x, positions, kc, vc,
                                               t, local=False)
                return x, (kc, vc)
            x, (state["k"], state["v"]) = _layers_decode(
                body, x, [params["blocks"], state["k"], state["v"]])
    elif cfg.family == "ssm":
        def body(x, xs):
            bp, cs, ss = xs
            x, cs, ss = _ssm_block_decode(bp, cfg, x, cs, ss)
            return x, (cs, ss)
        x, (state["conv"], state["ssm"]) = _layers_decode(
            body, x, [params["blocks"], state["conv"], state["ssm"]])
    else:  # hybrid
        shared = params["shared_attn"]

        def inner(x, ys):
            bp, c, s = ys
            x, c, s = _ssm_block_decode(bp, cfg, x, c, s)
            return x, (c, s)

        def body(x, xs):
            gp, cs, ss, kc, vc = xs
            x, (cs, ss) = _layers_decode(inner, x, [gp, cs, ss])
            x, kc, vc = _attn_block_decode(shared, cfg, x, positions, kc, vc,
                                           t, local=False)
            return x, (cs, ss, kc, vc)
        x, (state["conv"], state["ssm"], state["k"], state["v"]) = \
            _layers_decode(body, x, [params["blocks"], state["conv"],
                                     state["ssm"], state["k"], state["v"]])

    logits = _logits(params, cfg, x)[:, 0]
    state["cache_len"] = t + 1
    return state, logits
