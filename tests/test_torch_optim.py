"""The port's AdamW, global-norm clip and LR schedules against the JAX
package's `repro.optim`: the same weights, gradients and steps in, the
same numbers out — the clip and three AdamW steps at rtol 1e-6 (float32
sums of squares in another order), the schedules at rtol 1e-7 (float32,
the same operations in the same order). `torch.optim.AdamW` would fail
the update check: it decays the weights before the Adam step."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.model import M4Config as JaxM4Config  # noqa: E402
from repro.core.model import init_m4 as jax_init  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch.optim import (adamw_init, adamw_update,  # noqa: E402
                               clip_by_global_norm, cosine_schedule,
                               linear_warmup_cosine)
from repro_torch.weights import params_from_jax, tree_leaves  # noqa: E402

RTOL = 1e-6
SCHED_RTOL = 1e-7
TINY = dict(hidden=16, gnn_dim=12, mlp_hidden=8, gnn_layers=2,
            snap_flows=8, snap_links=24)


@pytest.fixture(scope="module")
def jax_params():
    return jax_init(jax.random.PRNGKey(0), JaxM4Config(**TINY))


def _close(got, want, rtol):
    for (path, a), (_, b) in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=rtol, atol=0, err_msg=path)


def _grads(params, seed, scale):
    rng = np.random.default_rng(seed)
    g = jax.tree.map(lambda p: (rng.normal(size=p.shape) * scale)
                     .astype(np.float32), params)
    g["mlp_size"]["l2"]["b"] = np.full((1,), 1e-12, np.float32)
    return g


@pytest.mark.parametrize("max_norm,scale", [(1.0, 0.05), (1.0, 1e-4),
                                            (0.3, 1.0)])
def test_clip_matches_jax(jax_params, max_norm, scale):
    jp = jax.device_get(jax_params)
    g = _grads(jp, 1, scale)
    jg, jgn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                         max_norm)
    tg, tgn = clip_by_global_norm(params_from_jax(g, "cpu"), max_norm)
    np.testing.assert_allclose(float(tgn), float(jgn), rtol=RTOL)
    _close(tg, jg, RTOL)


def test_three_adamw_steps_match_jax(jax_params):
    jp = jax_params
    tp = params_from_jax(jax.device_get(jp), "cpu")
    jstate, tstate = jadamw.adamw_init(jp), adamw_init(tp)
    assert tstate["step"].dtype == torch.int32
    for i, lr in enumerate((3e-4, 1e-3, 2.5e-4)):
        g = _grads(jax.device_get(jp), 10 + i, 0.1)
        jp, jstate = jadamw.adamw_update(
            jp, jax.tree.map(jnp.asarray, g), jstate,
            lr=jnp.asarray(lr, jnp.float32), weight_decay=1e-4)
        tp, tstate = adamw_update(
            tp, params_from_jax(g, "cpu"), tstate,
            lr=torch.tensor(lr, dtype=torch.float32), weight_decay=1e-4)
        _close(tp, jp, RTOL)
        _close(tstate["m"], jstate["m"], RTOL)
        _close(tstate["v"], jstate["v"], RTOL)
        assert int(tstate["step"]) == int(jstate["step"]) == i + 1


def test_adamw_leaves_its_arguments_alone():
    p = {"w": torch.ones(3)}
    st = adamw_init(p)
    new, st2 = adamw_update(p, {"w": torch.ones(3)}, st, lr=0.1)
    assert torch.equal(p["w"], torch.ones(3)) and int(st["step"]) == 0
    assert int(st2["step"]) == 1 and not torch.equal(new["w"], p["w"])


@pytest.mark.parametrize("kind", ["warmcos", "cosine"])
def test_schedules_match_jax(kind):
    if kind == "warmcos":
        jf = jsched.linear_warmup_cosine(3e-4, 5, 40, min_frac=0.05)
        tf = linear_warmup_cosine(3e-4, 5, 40, min_frac=0.05)
    else:
        jf = jsched.cosine_schedule(1e-3, 17, min_frac=0.1)
        tf = cosine_schedule(1e-3, 17, min_frac=0.1)
    for step in (0, 1, 3, 5, 6, 12, 20, 39, 40, 41, 60):
        want = float(jf(jnp.asarray(step, jnp.int32)))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=SCHED_RTOL,
                                   err_msg=f"step {step}")
