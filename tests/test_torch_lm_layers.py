"""The LM substrate's layers in the port (`repro_torch.nn`) against the
JAX package's (`repro.nn`), module by module, on the CPU: the same
seeded inputs and weights (drawn by the port's initialisers, then handed
to JAX as numpy) through both, at rtol and atol 1e-5 in float32, or 1e-4
for the SSD scan (tests/test_nn.py:44-47 holds it so):

- rmsnorm, layernorm, embedding (with its dtype cast), and `linear`'s
  cast of the weight to the activation's dtype;
- RoPE, and M-RoPE with three distinct position streams;
- the causal and sliding-window masks, bitwise;
- attention, forward and decode (GQA, qk-norm, softcap, window, M-RoPE);
- `_ssd_chunked` (with and without an initial state), SSM forward and
  decode;
- MoE output and aux loss: a routed case over two groups, a forced top-k
  tie (every router logit equal: JAX breaks ties to the lower index, and
  so must the port), and a group that overflows its capacity.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import nn as jnn  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro.nn.ssm import _ssd_chunked as jax_ssd  # noqa: E402
from repro_torch import nn  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402
from repro_torch.nn.ssm import _ssd_chunked  # noqa: E402
from repro_torch.weights import params_to_numpy, tree_map  # noqa: E402

TOL = 1e-5
SSD_TOL = 1e-4


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, params_to_numpy(tree))


def jit(fn, cfg):
    """fn(p, cfg, *args) of the JAX package, compiled once with its config
    static (faster than op-by-op dispatch)."""
    return jax.jit(lambda p, *args: fn(p, cfg, *args))


def rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------- layers
def test_norms_embedding_and_linear_cast():
    rng = np.random.default_rng(0)
    x = rand(rng, 2, 5, 16)
    p = {"scale": rand(rng, 16)}
    close(nn.rmsnorm(tree_map(torch.from_numpy, p), torch.from_numpy(x)),
          jnn.rmsnorm(to_jax(tree_map(torch.from_numpy, p)), jnp.asarray(x)))
    ln = {"scale": rand(rng, 16), "bias": rand(rng, 16)}
    tln = tree_map(torch.from_numpy, ln)
    close(nn.layernorm(tln, torch.from_numpy(x)),
          jnn.layernorm(to_jax(tln), jnp.asarray(x)))
    emb = nn.embedding_init(gen(1), 32, 16)
    ids = rng.integers(0, 32, (2, 5))
    close(nn.embedding(emb, torch.from_numpy(ids)),
          jnn.embedding(to_jax(emb), jnp.asarray(ids)))
    got = nn.embedding(emb, torch.from_numpy(ids), dtype=torch.bfloat16)
    want = jnn.embedding(to_jax(emb), jnp.asarray(ids), dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    close(got.float(), np.asarray(want.astype(jnp.float32)))
    # bfloat16 activations: the float32 weight is cast first
    lin = nn.linear_init(gen(2), 16, 8)
    lin["b"] = torch.from_numpy(rand(rng, 8))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = nn.linear(lin, xb)
    want = jnn.linear(to_jax(lin), jnp.asarray(x).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    close(got.float(), np.asarray(want.astype(jnp.float32)), 1e-2)
    assert torch.equal(got, xb @ lin["w"].to(torch.bfloat16)
                       + lin["b"].to(torch.bfloat16))


def test_rope_and_mrope():
    rng = np.random.default_rng(1)
    x = rand(rng, 2, 6, 4, 8)
    pos = np.arange(6, dtype=np.int32)[None] + np.array([[0], [5]],
                                                        dtype=np.int32)
    close(nn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        theta=1e4),
          jnn.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=1e4))
    pos3 = rng.integers(0, 40, (3, 2, 6)).astype(np.int32)
    close(nn.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                         (1, 1, 2), theta=1e6),
          jnn.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), (1, 1, 2),
                          theta=1e6))


@pytest.mark.parametrize("S,T,window", [(5, None, 0), (4, 9, 0), (9, None, 3),
                                        (3, 10, 4)])
def test_causal_and_sliding_masks_bitwise(S, T, window):
    got = nn.causal_mask(S, T, sliding_window=window)
    want = jnn.causal_mask(S, T, sliding_window=window)
    assert np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------- attention
ATTN = {
    "gqa": dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8),
    "qknorm_softcap": dict(d_model=32, num_heads=4, num_kv_heads=1,
                           head_dim=8, qk_norm=True, logit_softcap=5.0,
                           rope_theta=1e6),
    "window": dict(d_model=32, num_heads=2, num_kv_heads=2, head_dim=16,
                   sliding_window=3),
    "mrope": dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
                  mrope_sections=(1, 1, 2)),
}


@pytest.mark.parametrize("name", sorted(ATTN))
def test_attention_forward_and_decode(name):
    cfg, jcfg = nn.AttnCfg(**ATTN[name]), jnn.AttnCfg(**ATTN[name])
    p = nn.attn_init(gen(3), cfg)
    if cfg.qk_norm:
        rng0 = np.random.default_rng(9)
        p["qn"]["scale"] = torch.from_numpy(rand(rng0, cfg.head_dim))
        p["kn"]["scale"] = torch.from_numpy(rand(rng0, cfg.head_dim))
    jp = to_jax(p)
    rng = np.random.default_rng(4)
    B, S, T = 2, 7, 10
    x = rand(rng, B, S, cfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    if cfg.mrope_sections:
        pos = rng.integers(0, 20, (3, B, S)).astype(np.int32)
    close(nn.attn_forward(p, cfg, torch.from_numpy(x),
                          torch.from_numpy(np.array(pos))),
          jit(jnn.attn_forward, jcfg)(jp, jnp.asarray(x), jnp.asarray(pos)))
    # decode one token at index 4 of a cache holding 4 earlier tokens
    kc = rand(rng, B, T, cfg.num_kv_heads, cfg.head_dim)
    vc = rand(rng, B, T, cfg.num_kv_heads, cfg.head_dim)
    x1 = rand(rng, B, 1, cfg.d_model)
    pos1 = np.full((B, 1), 4, np.int32)
    if cfg.mrope_sections:
        pos1 = np.full((3, B, 1), 4, np.int32)
    kct = torch.from_numpy(kc.copy())
    got = nn.attn_decode(p, cfg, torch.from_numpy(x1),
                         torch.from_numpy(pos1), kct,
                         torch.from_numpy(vc), torch.tensor(4))
    want = jit(jnn.attn_decode, jcfg)(jp, jnp.asarray(x1), jnp.asarray(pos1),
                                      jnp.asarray(kc), jnp.asarray(vc),
                                      jnp.int32(4))
    for g, w in zip(got, want):
        close(g, w)
    assert np.array_equal(kct.numpy(), kc)    # the cache passed in stays
    assert not torch.equal(got[1], kct)


# ------------------------------------------------------------------ SSM
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_jax(with_h0):
    rng = np.random.default_rng(5)
    B, S, H, P, N = 2, 24, 3, 4, 5
    xh, Bm, Cm = rand(rng, B, S, H, P), rand(rng, B, S, N), rand(rng, B, S, N)
    dtA = -np.abs(rand(rng, B, S, H))
    h0 = rand(rng, B, H, P, N) if with_h0 else None
    got = _ssd_chunked(*(torch.from_numpy(a) for a in (xh, dtA, Bm, Cm)),
                       chunk=8, h0=None if h0 is None
                       else torch.from_numpy(h0))
    want = jax_ssd(*(jnp.asarray(a) for a in (xh, dtA, Bm, Cm)), chunk=8,
                   h0=None if h0 is None else jnp.asarray(h0))
    for g, w in zip(got, want):
        close(g, w, SSD_TOL)
    with pytest.raises(AssertionError):
        _ssd_chunked(*(torch.from_numpy(a[:, :20]) for a in (xh, dtA, Bm,
                                                             Cm)), chunk=8)


def test_ssm_forward_and_decode():
    cfg = nn.SSMCfg(d_model=16, d_inner=32, d_state=6, head_dim=8, chunk=4)
    jcfg = jnn.SSMCfg(**cfg._asdict())
    p = nn.ssm_init(gen(6), cfg)
    rng = np.random.default_rng(6)
    p["dt_bias"] = torch.from_numpy(rand(rng, cfg.nheads))
    p["D"] = torch.from_numpy(rand(rng, cfg.nheads))
    jp = to_jax(p)
    x = rand(rng, 2, 12, 16)
    close(nn.ssm_forward(p, cfg, torch.from_numpy(x)),
          jit(jnn.ssm_forward, jcfg)(jp, jnp.asarray(x)), SSD_TOL)
    conv = rand(rng, 2, 3, cfg.d_inner + 2 * cfg.d_state)
    state = rand(rng, 2, cfg.nheads, cfg.head_dim, cfg.d_state)
    got = nn.ssm_decode(p, cfg, torch.from_numpy(x[:, :1]),
                        torch.from_numpy(conv), torch.from_numpy(state))
    want = jit(jnn.ssm_decode, jcfg)(jp, jnp.asarray(x[:, :1]),
                                     jnp.asarray(conv), jnp.asarray(state))
    for g, w in zip(got, want):
        close(g, w)


# ------------------------------------------------------------------ MoE
MOE = {
    # 32 tokens in 2 groups of 16, routed by a random router
    "routed": (dict(d_model=16, d_ff=24, num_experts=4, top_k=2,
                    group_size=16), False),
    # every logit equal: ties everywhere, and 16 tokens pile on experts
    # 0 and 1, past their capacity of 12
    "tie_overflow": (dict(d_model=16, d_ff=24, num_experts=4, top_k=2,
                          group_size=64), True),
    # top-1 with the shared expert
    "shared_top1": (dict(d_model=16, d_ff=24, num_experts=4, top_k=1,
                         shared_d_ff=20, group_size=64), False),
}


@pytest.mark.parametrize("name", sorted(MOE))
def test_moe_matches_jax(name):
    kw, tie = MOE[name]
    cfg, jcfg = nn.MoECfg(**kw), jnn.MoECfg(**kw)
    p = nn.moe_init(gen(7), cfg)
    if tie:
        p["router"]["w"] = torch.zeros_like(p["router"]["w"])
    rng = np.random.default_rng(7)
    B, S = (2, 16) if name == "routed" else (1, 16)
    x = rand(rng, B, S, cfg.d_model)
    got, aux = nn.moe_forward(p, cfg, torch.from_numpy(x))
    want, jaux = jit(jnn.moe_forward, jcfg)(to_jax(p), jnp.asarray(x))
    close(got, want)
    close(aux, jaux)
    if tie:
        G = B * S
        C = tmoe._capacity(cfg, G)
        assert C == jmoe._capacity(jcfg, G) == 12 < G
        # the ties go to the lower indices, as jax.lax.top_k's
        probs = torch.full((1, G, cfg.num_experts), 0.25)
        vals, idx = tmoe.top_k(probs, cfg.top_k)
        jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), cfg.top_k)
        assert np.array_equal(idx.numpy(), np.asarray(ji))
        assert (idx[..., 0] == 0).all() and (idx[..., 1] == 1).all()
        # tokens past capacity are dropped: their output is 0
        assert (got.reshape(G, -1)[C:] == 0).all()
        assert (got.reshape(G, -1)[:C] != 0).any()
