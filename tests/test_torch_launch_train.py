"""The port's LM trainer (`repro_torch.launch.train`) against the
JAX package's `repro.launch.train`, on the CPU at `reduce_for_smoke`:

- the loss and its gradients, leaf by leaf, against `jax.value_and_grad`
  of JAX's `loss_fn`, B 2, S 16, from the port's weights handed to JAX as
  numpy, for a dense, an MoE, an SSM and a hybrid arch;
- two `make_train_step` steps from those weights for the same archs (and
  the dense one with `compress_frac=0.05`, against JAX's step run
  eagerly: under jit it fails): after each, loss, gradient norm, weights,
  moments and error feedback. Every leaf is held at rtol 1e-4 with an atol
  of 1e-4 times its largest magnitude (at most 1), so a wrong magnitude in
  one leaf shows;
  the second step's weights depend on the sizes of m and v, not only on
  the gradients' signs;
- a bfloat16 tree over two steps: every leaf's dtype is JAX's after each
  (weights float32 after the first, moments after the second);
- `train`'s crash and resume against its uninterrupted run at rtol 1e-5
  (tests/test_runtime.py's bound), and the donating step the train loop
  takes against the pure one and AdamW in chunks against one call,
  bitwise;
- JAX's `train` resuming from a port checkpoint and the port's from a
  JAX one: losses at 1e-5;
- both CLIs from one step-0 checkpoint: the same first and last loss at
  1e-4; and the port's examples/train_lm_torch.py lowering its loss.
"""
import importlib.util
import os
import re
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import linear_warmup_cosine as jschedule  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import (adamw_init, adamw_update,  # noqa: E402
                               linear_warmup_cosine)
from repro_torch.weights import leaf_numpy, tree_leaves, tree_map  # noqa: E402

TOL = 1e-4
RESUME_RTOL = 1e-5          # tests/test_runtime.py:82
B, S = 2, 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _quiet(*a):
    pass


def _cfgs(arch, dtype=None):
    t = configs.reduce_for_smoke(configs.get_config(arch))
    j = jconfigs.reduce_for_smoke(jconfigs.get_config(arch))
    if dtype is not None:
        t, j = t.with_(dtype=torch.bfloat16), j.with_(dtype=jnp.bfloat16)
    return t, j


def _to_jax(tree):
    """The port's tree as JAX arrays of the same dtypes (bfloat16 leaves
    through their exact float32 values)."""
    def leaf(x):
        a = jnp.asarray(leaf_numpy(x))
        return a.astype(jnp.bfloat16) if x.dtype == torch.bfloat16 else a
    return tree_map(leaf, tree)


def _close(got, want, what):
    """Leaf by leaf at rtol TOL and an atol of TOL times the leaf's largest
    magnitude (at most 1): each leaf is held at its own scale."""
    for (path, a), b in zip(tree_leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(
            leaf_numpy(a), b, rtol=TOL,
            atol=TOL * min(1.0, float(np.abs(b).max(initial=0.0))),
            err_msg=f"{what} {path}")


def _batches(cfg, n):
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=0)
    return [pipe.batch(i) for i in range(n)]


def _steps(cfg, jcfg, frac, n, params):
    """n steps of both packages' make_train_step from `params`; yields
    (port state, JAX state, port loss, gn, JAX loss, gn) after each."""
    sched_t = linear_warmup_cosine(3e-4, 1, 10)
    sched_j = jschedule(3e-4, 1, 10)
    t_step = ttrain.make_train_step(cfg, sched_t, compress_frac=frac)
    j_step = jtrain.make_train_step(jcfg, sched_j, compress_frac=frac)
    err = (tree_map(torch.zeros_like, params) if frac > 0 else
           tree_map(lambda x: torch.zeros((0,), dtype=x.dtype), params))
    t = (params, adamw_init(params), err)
    j = tuple(_to_jax(x) for x in t)
    for i, batch in enumerate(_batches(cfg, n)):
        # step_i 1 first: the warm-up's lr is 0 at step 0
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        *t, tl, tg = t_step(*t, tb, torch.tensor(i + 1, dtype=torch.int32))
        *j, jl, jg = j_step(*j, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, jnp.int32(i + 1))
        yield t, j, tl, tg, jl, jg


ARCHS = ["yi-34b", "moonshot-v1-16b-a3b", "mamba2-1.3b", "zamba2-2.7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax(arch):
    cfg, jcfg = _cfgs(arch)
    params = lm.init_params(torch.Generator().manual_seed(3), cfg)
    batch = _batches(cfg, 1)[0]
    loss, grads = ttrain.loss_and_grads(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b)[0]))(
            _to_jax(params), {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    assert len(list(tree_leaves(grads))) == len(jax.tree.leaves(jgrads))
    _close(grads, jgrads, "grad")


@pytest.mark.parametrize("arch,frac", [(a, 0.0) for a in ARCHS]
                         + [("yi-34b", 0.05)])
def test_one_step_matches_jax(arch, frac):
    """The step from the same weights, then the step after it."""
    cfg, jcfg = _cfgs(arch)
    params = lm.init_params(torch.Generator().manual_seed(3), cfg)
    before = tree_map(torch.clone, params)
    # JAX's compressing step cannot run under jit: `topk_decompress` takes
    # int() of a traced shape product (src/repro/optim/compress.py:25), so
    # its arithmetic is taken eagerly
    with jax.disable_jit(frac > 0):
        for n, (t, j, tl, tg, jl, jg) in enumerate(
                _steps(cfg, jcfg, frac, 2, params), 1):
            np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
            np.testing.assert_allclose(float(tg), float(jg), rtol=TOL)
            _close(t[0], j[0], f"step {n} params")
            _close(t[1]["m"], j[1]["m"], f"step {n} m")
            _close(t[1]["v"], j[1]["v"], f"step {n} v")
            _close(t[2], j[2], f"step {n} err")
            assert int(t[1]["step"]) == int(j[1]["step"]) == n
    for (path, a), (_, b) in zip(tree_leaves(params), tree_leaves(before)):
        assert torch.equal(a, b), f"the step wrote into its argument {path}"


def test_bf16_leaf_dtypes_follow_jax_over_two_steps():
    """The promotion fault: a bfloat16 weight meets AdamW's float32 bias
    correction, which JAX promotes to float32 and torch did not."""
    cfg, jcfg = _cfgs("yi-34b", torch.bfloat16)
    params = lm.init_params(torch.Generator().manual_seed(4), cfg)
    seen = []
    for t, j, *_ in _steps(cfg, jcfg, 0.0, 2, params):
        for name, tt, jj in (("params", t[0], j[0]), ("m", t[1]["m"],
                                                      j[1]["m"]),
                             ("v", t[1]["v"], j[1]["v"])):
            for (path, a), b in zip(tree_leaves(tt), jax.tree.leaves(jj)):
                assert str(a.dtype).split(".")[-1] == str(b.dtype), \
                    f"{name} {path}: {a.dtype} against JAX's {b.dtype}"
        seen.append((next(tree_leaves(t[0]))[1].dtype,
                     next(tree_leaves(t[1]["m"]))[1].dtype))
    assert seen == [(torch.float32, torch.bfloat16),
                    (torch.float32, torch.float32)]


def test_donated_step_equals_the_pure_step():
    cfg, _ = _cfgs("zamba2-2.7b")
    params = lm.init_params(torch.Generator().manual_seed(5), cfg)
    step = ttrain.make_train_step(cfg, linear_warmup_cosine(3e-4, 1, 10),
                                  compress_frac=0.1)
    state = [params, adamw_init(params), tree_map(torch.zeros_like, params)]
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, 1)[0].items()}
    i = torch.tensor(1, dtype=torch.int32)
    *pure, loss, gn = step(*state, batch, i)
    held = list(state)
    new, dloss, dgn = step.donated(state, batch, i)
    assert state == [] and torch.equal(loss, dloss) and torch.equal(gn, dgn)
    for a, b in zip(tree_leaves(pure), tree_leaves(new)):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]
    del held


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_adamw_equals_one_call(monkeypatch, dtype):
    """The step's AdamW over a leaf in chunks (what a full-width leaf takes
    on the card) gives one call's numbers and dtypes, bitwise."""
    gen = torch.Generator().manual_seed(6)
    p, g, m = (torch.randn(5, 77, generator=gen).to(dtype) for _ in range(3))
    v = torch.rand(5, 77, generator=gen).to(dtype)
    count, lr = torch.tensor(3, dtype=torch.int32), torch.tensor(3e-4)
    monkeypatch.setitem(ttrain.CHUNK, "cpu", 64)
    got = ttrain._adamw_leaf(p, g, m, v, count, lr)
    new_p, st = adamw_update(p, g, {"m": m, "v": v, "step": count}, lr=lr,
                             weight_decay=ttrain.WEIGHT_DECAY)
    for a, b in zip(got, (new_p, st["m"], st["v"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_train_resume_matches_uninterrupted(tmp_path):
    cfg, _ = _cfgs("yi-34b")
    kw = dict(steps=8, global_batch=B, seq_len=S, log=_quiet, device="cpu")
    _, full = ttrain.train(cfg, ckpt_dir=None, **kw)
    d = str(tmp_path)
    _, head = ttrain.train(cfg, ckpt_dir=d, ckpt_every=4, crash_at=4, **kw)
    _, tail = ttrain.train(cfg, ckpt_dir=d, ckpt_every=100, resume="auto",
                           **kw)
    assert len(head) == 4 and len(tail) == 4
    np.testing.assert_allclose(head + tail, full, rtol=RESUME_RTOL)


def _run_with_ckpt_at_2(fn, cfg, d, **kw):
    """A 4-step run that leaves its step-2 checkpoint as the newest."""
    _, losses = fn(cfg, steps=4, global_batch=B, seq_len=S, ckpt_dir=d,
                   ckpt_every=2, log=_quiet, **kw)
    shutil.rmtree(os.path.join(d, "step_0000000004"))
    return losses


def test_each_package_resumes_from_the_others_checkpoint(tmp_path):
    cfg, jcfg = _cfgs("yi-34b")
    dt, dj = str(tmp_path / "torch"), str(tmp_path / "jax")
    t_full = _run_with_ckpt_at_2(ttrain.train, cfg, dt, device="cpu")
    j_full = _run_with_ckpt_at_2(jtrain.train, jcfg, dj)
    _, j_tail = jtrain.train(jcfg, steps=4, global_batch=B, seq_len=S,
                             ckpt_dir=dt, resume="auto", log=_quiet)
    _, t_tail = ttrain.train(cfg, steps=4, global_batch=B, seq_len=S,
                             ckpt_dir=dj, resume="auto", log=_quiet,
                             device="cpu")
    np.testing.assert_allclose(j_tail, t_full[2:], rtol=RESUME_RTOL)
    np.testing.assert_allclose(t_tail, j_full[2:], rtol=RESUME_RTOL)


def _first_last(text):
    m = re.search(r"first loss ([\d.]+) -> last ([\d.]+)", text)
    return float(m.group(1)), float(m.group(2))


def test_cli_losses_equal_jax_cli_from_one_checkpoint(tmp_path, capsys,
                                                      monkeypatch):
    """`python -m repro_torch.launch.train --arch yi-34b --smoke --steps 4
    --device cpu` and JAX's CLI, both resuming from the same step-0
    checkpoint (the two packages draw their weights from different
    generators)."""
    cfg, _ = _cfgs("yi-34b")
    d0 = str(tmp_path / "t")
    ttrain.train(cfg, steps=0, ckpt_dir=d0, log=_quiet, device="cpu")
    dj = str(tmp_path / "j")
    shutil.copytree(d0, dj)
    args = ["--arch", "yi-34b", "--smoke", "--steps", "4", "--resume",
            "auto"]
    ttrain.main(args + ["--ckpt-dir", d0, "--device", "cpu"])
    ours = _first_last(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["train"] + args + ["--ckpt-dir", dj])
    jtrain.main()
    theirs = _first_last(capsys.readouterr().out)
    np.testing.assert_allclose(ours, theirs, rtol=TOL)


def test_example_train_lm_torch_lowers_the_loss(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", os.path.join(ROOT, "examples", "train_lm_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    losses = mod.main(["--ci", "--device", "cpu", "--ckpt-dir",
                       str(tmp_path)])
    assert len(losses) == 60 and losses[-1] < losses[0]
    assert "reduction" in capsys.readouterr().out
