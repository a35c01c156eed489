"""The LM's serving path in the port (`repro_torch.models`,
`repro_torch.configs`) against the JAX package's, over the ten assigned
archs at `reduce_for_smoke`, on the CPU. The weights are the port's
`init_params` from a seeded `torch.Generator`, handed to JAX as numpy
(the same tree, leaf for leaf); the inputs are seeded numpy:

- `forward` (logits and aux), `prefill_step` and the `loss_fn` value
  (the loss also through the remat path, autograd on) at rtol and atol
  1e-5 against JAX's;
- eight `serve_step`s from an empty state: logits at 1e-5 and the state
  (caches, SSM states, `cache_len`) against JAX's; and six from a state
  of length 4, past its end, where JAX clamps the cache write into the
  last slot;
- the port's own decode against its forward on the prefix, at JAX's
  bound (tests/test_arch_smoke.py:79-103, 5e-3);
- the full configs' `param_count()` equal to JAX's, their dtypes
  bfloat16, and `input_specs` of every shape: the shapes and dtypes of
  JAX's `ShapeDtypeStruct`s, on the `meta` device (no storage);
- `params_from_jax` carries a bfloat16 LM tree bitwise (16-bit words),
  and `tree_digest` of it equals JAX's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.runtime.checkpoint import tree_digest as jax_digest  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.weights import (params_from_jax, params_to_numpy,  # noqa: E402
                                 tree_digest, tree_leaves, tree_map)

ARCHS = configs.list_archs()
TOL = 1e-5
DECODE_VS_FORWARD = 5e-3
B, S, STEPS = 2, 16, 8
PAST_MAX_LEN, PAST_STEPS = 4, 6     # two steps past the cache's length


def _batch(cfg, rng, B, S):
    """Seeded numpy inputs of one arch: tokens or stub-frontend embeds,
    M-RoPE positions where the arch has them, and labels."""
    batch = {}
    if cfg.frontend != "none":
        batch["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.mrope_sections:
        batch["positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32)[None, None], (3, B, S)).copy()
    batch["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k in ("tokens", "labels")
            else torch.from_numpy(v) for k, v in batch.items()}


def _step_batch(batch, t):
    out = {k: v[:, t:t + 1] for k, v in batch.items()
           if k in ("tokens", "embeds")}
    if "positions" in batch:
        out["positions"] = batch["positions"][:, :, t:t + 1]
    return out


_CACHE = {}


def computed(arch):
    """One arch's weights, inputs and JAX's results, computed once per
    arch (one compile of forward+prefill+loss, one of serve_step)."""
    if arch in _CACHE:
        return _CACHE[arch]
    cfg = configs.reduce_for_smoke(configs.get_config(arch))
    jcfg = jconfigs.reduce_for_smoke(jconfigs.get_config(arch))
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    jp = jax.tree.map(jnp.asarray, params_to_numpy(params))
    batch = _batch(cfg, np.random.default_rng(0), B, S)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    full = jax.jit(lambda p, b: (jlm.forward(p, jcfg, b, remat=False),
                                 jlm.prefill_step(p, jcfg, b),
                                 jlm.loss_fn(p, jcfg, b)[0]))
    (logits, aux), prefill, loss = full(jp, jb)
    step = jax.jit(lambda p, s, b: jlm.serve_step(p, jcfg, s, b))
    state = jlm.init_decode_state(jcfg, B, STEPS)
    steps = []
    for t in range(STEPS):
        state, lg = step(jp, state, {k: jnp.asarray(v) for k, v in
                                     _step_batch(batch, t).items()})
        steps.append(np.asarray(lg))
    _CACHE[arch] = dict(cfg=cfg, jcfg=jcfg, params=params, jparams=jp,
                        batch=batch, step=step,
                        logits=np.asarray(logits), aux=float(aux),
                        prefill=np.asarray(prefill), loss=float(loss),
                        steps=steps, state=jax.device_get(state))
    return _CACHE[arch]


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_loss_match_jax(arch):
    c = computed(arch)
    cfg, params, tb = c["cfg"], c["params"], _torch_batch(c["batch"])
    with torch.no_grad():
        logits, aux = lm.forward(params, cfg, tb)
        prefill = lm.prefill_step(params, cfg, tb)
        loss, parts = lm.loss_fn(params, cfg, tb)
    assert logits.shape == (B, S, cfg.padded_vocab)
    close(logits, c["logits"])
    close(aux, c["aux"])
    close(prefill, c["prefill"])
    close(loss, c["loss"])
    close(parts["nll"] + 0.01 * parts["aux"], c["loss"])
    # the training path: each layer under torch.utils.checkpoint
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss_g, _ = lm.loss_fn(leaves, cfg, tb)
    close(loss_g, c["loss"])
    loss_g.backward()
    grads = [p.grad for _, p in tree_leaves(leaves) if p.grad is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_jax(arch):
    c = computed(arch)
    cfg, params = c["cfg"], c["params"]
    state = lm.init_decode_state(cfg, B, STEPS)
    with torch.no_grad():
        for t, want in enumerate(c["steps"]):
            state, lg = lm.serve_step(params, cfg, state, _torch_batch(
                _step_batch(c["batch"], t)))
            assert lg.shape == (B, cfg.padded_vocab)
            close(lg, want)
    assert sorted(state) == sorted(c["state"])
    assert int(state["cache_len"]) == int(c["state"]["cache_len"]) == STEPS
    for k, v in state.items():
        close(v, c["state"][k])


# a GQA arch, one with a sliding window, and the hybrid's shared attention
@pytest.mark.parametrize("arch", ["gemma-7b", "gemma2-9b", "zamba2-2.7b"])
def test_serve_steps_past_max_len_match_jax(arch):
    """Decoding past the cache's length: JAX's `dynamic_update_slice`
    clamps the write into the last slot, and the mask then admits every
    slot; the port does the same."""
    c = computed(arch)
    cfg, params = c["cfg"], c["params"]
    jstate = jlm.init_decode_state(c["jcfg"], B, PAST_MAX_LEN)
    state = lm.init_decode_state(cfg, B, PAST_MAX_LEN)
    with torch.no_grad():
        for t in range(PAST_STEPS):
            step = _step_batch(c["batch"], t)
            jstate, want = c["step"](c["jparams"], jstate, {
                k: jnp.asarray(v) for k, v in step.items()})
            state, lg = lm.serve_step(params, cfg, state, _torch_batch(step))
            close(lg, np.asarray(want))
    jstate = jax.device_get(jstate)
    assert sorted(state) == sorted(jstate)
    assert int(state["cache_len"]) == int(jstate["cache_len"]) == PAST_STEPS
    for k, v in state.items():
        close(v, jstate[k])


# all but llama4-scout, whose top-1 routing at this width can pass an
# expert's capacity of 4 tokens in the 8-token forward and drop a token
# that the one-token decode keeps (JAX's own test leaves it out too)
@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if a != "llama4-scout-17b-a16e"])
def test_decode_matches_forward_prefix(arch):
    cfg = configs.reduce_for_smoke(configs.get_config(arch))
    params = lm.init_params(torch.Generator().manual_seed(2), cfg)
    T = 8
    tb = _torch_batch(_batch(cfg, np.random.default_rng(2), 1, T))
    with torch.no_grad():
        full, _ = lm.forward(params, cfg, tb, remat=False)
        state = lm.init_decode_state(cfg, 1, T + 1)
        outs = []
        for t in range(T):
            step = {k: v[:, t:t + 1] for k, v in tb.items()
                    if k in ("tokens", "embeds")}
            if "positions" in tb:
                step["positions"] = tb["positions"][:, :, t:t + 1]
            state, lg = lm.serve_step(params, cfg, state, step)
            outs.append(lg)
    err = float((torch.stack(outs, 1) - full).abs().max())
    assert err < DECODE_VS_FORWARD, f"{arch}: decode/forward gap {err}"


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_counts_and_input_specs_match_jax(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert cfg.param_count() == jcfg.param_count() > 1e9
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.dtype == torch.bfloat16
    assert (cfg.padded_vocab, cfg.d_inner, cfg.attn_free) == \
        (jcfg.padded_vocab, jcfg.d_inner, jcfg.attn_free)
    for shape in configs.SHAPES:
        assert configs.shape_applicable(cfg, shape) == \
            jconfigs.shape_applicable(jcfg, shape)
        kind, specs = configs.input_specs(cfg, shape)
        jkind, jspecs = jconfigs.input_specs(jcfg, shape)
        assert kind == jkind
        got, want = dict(tree_leaves(specs)), dict(tree_leaves(jspecs))
        assert sorted(got) == sorted(want)
        for path, t in got.items():
            assert t.device.type == "meta", path
            assert tuple(t.shape) == tuple(want[path].shape), path
            assert str(t.dtype).split(".")[-1] == str(want[path].dtype), path


def test_bfloat16_lm_tree_carried_bitwise():
    """A bfloat16 tree from JAX (numpy's bfloat16 leaves) crosses as
    torch.bfloat16 through its 16-bit words: the values and JAX's
    tree_digest are kept."""
    cfg = configs.reduce_for_smoke(configs.get_config("zamba2-2.7b"))
    params = lm.init_params(torch.Generator().manual_seed(3), cfg)
    jtree = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                         params_to_numpy(params))
    carried = params_from_jax(jax.device_get(jtree), "cpu")
    for (path, t), (_, j) in zip(tree_leaves(carried),
                                 tree_leaves(jax.device_get(jtree))):
        assert t.dtype == torch.bfloat16, path
        assert np.array_equal(t.view(torch.int16).numpy(),
                              np.asarray(j).view(np.int16)), path
    assert tree_digest(carried) == jax_digest(jtree)
