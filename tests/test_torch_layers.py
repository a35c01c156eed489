"""The port's layers, initialisers and weight bridge against the JAX
package (`repro.nn.layers`, `repro.core.model.init_m4`)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.model import M4Config as JaxM4Config  # noqa: E402
from repro.core.model import init_m4 as jax_init_m4  # noqa: E402
from repro.nn import layers as jl  # noqa: E402
from repro_torch.core.model import M4Config, init_m4  # noqa: E402
from repro_torch.nn import layers as tl  # noqa: E402
from repro_torch.sim import get_backend  # noqa: E402
from repro_torch.weights import (params_from_jax, params_to_numpy,  # noqa: E402
                                 weights_digest)

TOL = 1e-5
GATE = dict(hidden=16, gnn_dim=16, mlp_hidden=16, gnn_layers=2,
            snap_flows=16, snap_links=32)


def _both(tree):
    """(jax tree, port tree) of one numpy tree."""
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    return jt, params_from_jax(tree, "cpu")


@pytest.mark.parametrize("d_in,d_out,B", [(5, 7, 3), (13, 400, 64),
                                          (309, 300, 128)])
def test_linear_matches_jax(d_in, d_out, B):
    rng = np.random.default_rng(d_in)
    p = {"w": (rng.normal(size=(d_in, d_out)) / np.sqrt(d_in)).astype(
        np.float32),
         "b": rng.normal(size=(d_out,)).astype(np.float32)}
    x = rng.normal(size=(B, d_in)).astype(np.float32)
    jp, tp = _both(p)
    np.testing.assert_allclose(tl.linear(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jl.linear(jp, jnp.asarray(x))),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("sizes", [[4, 8, 3], [409, 200, 200, 1]])
def test_mlp_matches_jax(sizes):
    rng = np.random.default_rng(len(sizes))
    p = jax.device_get(jl.mlp_init(jax.random.PRNGKey(1), sizes))
    x = rng.normal(size=(2, 5, sizes[0])).astype(np.float32)
    jp, tp = _both(p)
    np.testing.assert_allclose(tl.mlp(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jl.mlp(jp, jnp.asarray(x))),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("B,Din,H", [(5, 7, 20), (64, 309, 400),
                                     (128, 11, 400)])
def test_gru_cell_matches_jax(B, Din, H):
    rng = np.random.default_rng(B + H)
    p = jax.device_get(jl.gru_init(jax.random.PRNGKey(B), Din, H))
    p["bi"] = rng.normal(size=(3 * H,)).astype(np.float32) * 0.1
    p["bh"] = rng.normal(size=(3 * H,)).astype(np.float32) * 0.1
    x = rng.normal(size=(B, Din)).astype(np.float32)
    h = rng.normal(size=(B, H)).astype(np.float32)
    jp, tp = _both(p)
    np.testing.assert_allclose(
        tl.gru_cell(tp, torch.from_numpy(x), torch.from_numpy(h)).numpy(),
        np.asarray(jl.gru_cell(jp, jnp.asarray(x), jnp.asarray(h))),
        rtol=TOL, atol=TOL)


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)


@pytest.mark.parametrize("dims", [GATE, {}])
def test_init_m4_has_the_jax_tree(dims):
    """Same keys, list layout and shapes as the JAX init; the seeded draws
    follow the same distributions (uniform ±1/sqrt(H) GRU weights,
    truncated-normal / sqrt(fan_in) linear weights, zero biases)."""
    jp = jax.device_get(jax_init_m4(jax.random.PRNGKey(0), JaxM4Config(**dims)))
    tp = params_to_numpy(init_m4(0, M4Config(**dims)))
    assert _shapes(tp) == _shapes(jp)
    H = M4Config(**dims).hidden
    for k in ("gru1", "gruA", "gru2", "gruB"):
        for w in ("wi", "wh"):
            assert np.abs(tp[k][w]).max() <= 1 / np.sqrt(H)
        assert not tp[k]["bi"].any() and not tp[k]["bh"].any()
    w = tp["proj_f"]["w"]
    assert np.abs(w).max() <= 2 / np.sqrt(w.shape[0])
    assert abs(w.std() * np.sqrt(w.shape[0]) - 0.88) < 0.1   # trunc. normal
    # seeded: the same seed gives the same weights, another seed others
    again = params_to_numpy(init_m4(0, M4Config(**dims)))
    other = params_to_numpy(init_m4(1, M4Config(**dims)))
    assert np.array_equal(again["gru1"]["wi"], tp["gru1"]["wi"])
    assert not np.array_equal(other["gru1"]["wi"], tp["gru1"]["wi"])


def test_bridge_round_trip_is_bitwise():
    jp = jax.device_get(jax_init_m4(jax.random.PRNGKey(3),
                                    JaxM4Config(**GATE)))
    back = params_to_numpy(params_from_jax(jp, "cpu"))
    flat_j, tree_j = jax.tree_util.tree_flatten(jp)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_j == tree_b
    for a, b in zip(flat_j, flat_b):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_fingerprint_names_package_weights_and_device():
    cfg = M4Config(**GATE)
    p0, p1 = init_m4(0, cfg), init_m4(1, cfg)
    fp0 = get_backend("m4", params=p0, cfg=cfg, device="cpu").fingerprint()
    fp1 = get_backend("m4", params=p1, cfg=cfg, device="cpu").fingerprint()
    assert fp0.startswith("m4_torch-") and fp0.endswith("-ktorch")
    assert fp0 != fp1
    assert weights_digest(p0) == weights_digest(init_m4(0, cfg))


def test_backend_defaults_to_the_card_and_never_falls_back():
    cfg = M4Config(**GATE)
    params = init_m4(0, cfg)
    if torch.cuda.is_available():
        assert get_backend("m4", params=params, cfg=cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_backend("m4", params=params, cfg=cfg)
