"""Plain versions of the port's two kernels against the JAX package's
Pallas kernels (run in interpret mode, as tests/test_kernels.py runs them
on the CPU) and their jnp oracles, at the shapes of tests/test_kernels.py
including m4's full width. Tolerances are those of tests/test_kernels.py:
1e-5 for the GRU, 1e-4 for the GNN round (fp32)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import simulate as jsim  # noqa: E402
from repro.kernels.bipartite.ops import bipartite_round as jax_round  # noqa: E402
from repro.kernels.bipartite.ref import bipartite_round_ref as jax_round_ref  # noqa: E402
from repro.kernels.fused_gru.ops import gru_cell as jax_gru_pallas  # noqa: E402
from repro.kernels.fused_gru.ref import gru_cell_ref as jax_gru_ref  # noqa: E402
from repro_torch.core import simulate as tsim  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.bipartite import ops as bip_ops  # noqa: E402
from repro_torch.kernels.bipartite import ref as bip_ref  # noqa: E402
from repro_torch.kernels.fused_gru import ops as gru_ops  # noqa: E402
from repro_torch.kernels.fused_gru import ref as gru_ref  # noqa: E402

GRU_TOL = 1e-5
GNN_TOL = 1e-4
T = torch.from_numpy


def _gru_inputs(rng, B, Din, H):
    return [rng.normal(size=s).astype(np.float32) * c for s, c in
            (((B, Din), 1.0), ((B, H), 1.0), ((Din, 3 * H), 0.1),
             ((H, 3 * H), 0.1), ((3 * H,), 0.1), ((3 * H,), 0.1))]


@pytest.mark.parametrize("B,Din,H", [
    (5, 7, 20), (16, 13, 64), (200, 13, 400), (64, 309, 400), (128, 128, 128),
])
def test_gru_plain_matches_pallas_and_ref(B, Din, H):
    x, h, wi, wh, bi, bh = _gru_inputs(np.random.default_rng(B * H), B, Din, H)
    args = [jnp.asarray(a) for a in (x, h, wi, wh, bi, bh)]
    want_pallas = np.asarray(jax_gru_pallas(*args, tile_b=8, interpret=True))
    want_ref = np.asarray(jax_gru_ref(*args))
    got = gru_ref.gru_cell_ref(*map(T, (x, h, wi, wh, bi, bh))).numpy()
    np.testing.assert_allclose(got, want_pallas, rtol=GRU_TOL, atol=GRU_TOL)
    np.testing.assert_allclose(got, want_ref, rtol=GRU_TOL, atol=GRU_TOL)


@pytest.mark.parametrize("Bf,Df,Bl,Dl,H", [(64, 13, 128, 11, 400),
                                           (64, 309, 128, 309, 400),
                                           (16, 13, 32, 11, 16)])
def test_gru_pair_dispatch_on_cpu_matches_jax(Bf, Df, Bl, Dl, H):
    """The pair of one m4 stage, batched over 2 scenarios, as
    dispatch.gru_cell_pair runs it on the CPU."""
    rng = np.random.default_rng(Df + H)
    xf, hf, wif, whf, bif, bhf = _gru_inputs(rng, 2 * Bf, Df, H)
    xl, hl, wil, whl, bil, bhl = _gru_inputs(rng, 2 * Bl, Dl, H)
    pf = {"wi": wif, "wh": whf, "bi": bif, "bh": bhf}
    pl = {"wi": wil, "wh": whl, "bi": bil, "bh": bhl}
    tp = lambda p: {k: T(v) for k, v in p.items()}  # noqa: E731
    out_f, out_l = dispatch.gru_cell_pair(
        tp(pf), tp(pl), T(xf).reshape(2, Bf, Df), T(hf).reshape(2, Bf, H),
        T(xl).reshape(2, Bl, Dl), T(hl).reshape(2, Bl, H))
    for got, (x, h, p) in ((out_f, (xf, hf, pf)), (out_l, (xl, hl, pl))):
        want = jax_gru_ref(jnp.asarray(x), jnp.asarray(h),
                           *(jnp.asarray(p[k]) for k in ("wi", "wh", "bi",
                                                         "bh")))
        np.testing.assert_allclose(got.reshape(x.shape[0], H).numpy(),
                                   np.asarray(want), rtol=GRU_TOL,
                                   atol=GRU_TOL)


def _round_inputs(SF, SL, G, P):
    rng = np.random.default_rng(SF * SL)
    E = SF * P
    return dict(
        f=rng.normal(size=(SF, G)).astype(np.float32),
        l=rng.normal(size=(SL, G)).astype(np.float32),
        edge_f=np.repeat(np.arange(SF), P),
        edge_l=rng.integers(0, SL, E),
        edge_mask=(rng.random(E) < 0.7).astype(np.float32),
        wf=(rng.normal(size=(2 * G, G)) * 0.1).astype(np.float32),
        wl=(rng.normal(size=(2 * G, G)) * 0.1).astype(np.float32),
        bf=(rng.normal(size=(G,)) * 0.1).astype(np.float32),
        bl=np.zeros((G,), np.float32))


ROUND_SHAPES = [(8, 16, 20, 4), (16, 48, 48, 8), (64, 128, 300, 8),
                (32, 64, 128, 6)]
ORDER = ("f", "l", "edge_f", "edge_l", "edge_mask", "wf", "wl", "bf", "bl")


@pytest.mark.parametrize("SF,SL,G,P", ROUND_SHAPES)
def test_bipartite_plain_forms_match_pallas_and_ref(SF, SL, G, P):
    a = _round_inputs(SF, SL, G, P)
    jargs = [jnp.asarray(a[k], jnp.int32 if k.startswith("edge_") and
                         k != "edge_mask" else jnp.float32) for k in ORDER]
    want_p = jax_round(*jargs, interpret=True)
    want_r = jax_round_ref(*jargs)
    targs = {k: T(np.asarray(v)) for k, v in a.items()}
    seg = bip_ref.bipartite_round_ref(*(targs[k] for k in ORDER))
    m = bip_ref.incidence_from_edges(targs["edge_f"], targs["edge_l"],
                                     targs["edge_mask"], SF, SL)
    layer = {"wf": {"w": targs["wf"], "b": targs["bf"]},
             "wl": {"w": targs["wl"], "b": targs["bl"]}}
    mm = bip_ref.bipartite_rounds_matmul([layer], targs["f"], targs["l"], m)
    for got in (seg, mm):
        for g, wp, wr in zip(got, want_p, want_r):
            np.testing.assert_allclose(g.numpy(), np.asarray(wp),
                                       rtol=GNN_TOL, atol=GNN_TOL)
            np.testing.assert_allclose(g.numpy(), np.asarray(wr),
                                       rtol=GNN_TOL, atol=GNN_TOL)


def test_bipartite_batched_equals_per_scenario():
    """A leading batch axis (per-scenario edges, shared edge_f) gives each
    scenario's own round, in both plain forms and through the dispatch."""
    SF, SL, G, P, B = 16, 32, 24, 4, 3
    ins = [_round_inputs(SF, SL, G, P) for _ in range(B)]
    for i, a in enumerate(ins):           # distinct edges per scenario
        a["edge_l"] = np.random.default_rng(i).integers(0, SL, SF * P)
    w = {k: T(ins[0][k]) for k in ("wf", "wl", "bf", "bl")}
    layer = {"wf": {"w": w["wf"], "b": w["bf"]},
             "wl": {"w": w["wl"], "b": w["bl"]}}
    stack = lambda k: T(np.stack([a[k] for a in ins]))  # noqa: E731
    edge_f = T(ins[0]["edge_f"])
    f, l = stack("f"), stack("l")
    el, em = stack("edge_l"), stack("edge_mask")
    seg = bip_ref.bipartite_round_ref(f, l, edge_f, el, em, w["wf"],
                                      w["wl"], w["bf"], w["bl"])
    disp = dispatch.gnn_rounds([layer], f, l, edge_f, el, em, SL)
    for b, a in enumerate(ins):
        one = bip_ref.bipartite_round_ref(
            T(a["f"]), T(a["l"]), edge_f, T(a["edge_l"]), T(a["edge_mask"]),
            w["wf"], w["wl"], w["bf"], w["bl"])
        for x, y, z in zip(seg, disp, one):
            np.testing.assert_allclose(x[b].numpy(), z.numpy(), rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(y[b].numpy(), z.numpy(),
                                       rtol=GNN_TOL, atol=GNN_TOL)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch on the card or raise: a CPU tensor is refused
    before any build or launch, and no launch is counted."""
    x, h = torch.zeros(4, 3), torch.zeros(4, 8)
    p = {"wi": torch.zeros(3, 24), "wh": torch.zeros(8, 24),
         "bi": torch.zeros(24), "bh": torch.zeros(24)}
    n = gru_ops.gru_pair.launches
    with pytest.raises(ValueError, match="CUDA"):
        gru_ops.gru_pair(p, p, x, h, x, h)
    assert gru_ops.gru_pair.launches == n
    f, l = torch.zeros(2, 4), torch.zeros(3, 4)
    e = torch.zeros(4, dtype=torch.long)
    w, b = torch.zeros(8, 4), torch.zeros(4)
    n = bip_ops.bipartite_round.launches
    with pytest.raises(ValueError, match="CUDA"):
        bip_ops.bipartite_round(f, l, e, e, torch.ones(4), w, w, b, b)
    assert bip_ops.bipartite_round.launches == n


@pytest.mark.parametrize("k", [8, 15, 32, 48])
def test_dedupe_ascending_matches_jax_in_both_regimes(k):
    """k <= 16 and k > 16 are the two regimes of the JAX dedupe; the port
    uses its sort path for both and must emit the same values."""
    rng = np.random.default_rng(k)
    vals = rng.integers(0, 40, size=(10, 96))
    vals[:, ::7] = 99                                       # sentinels
    got = tsim._dedupe_ascending(T(vals), k, 99).numpy()
    for row, g in zip(vals, got):
        want = jsim._dedupe_ascending(jnp.asarray(row, jnp.int32), k, 99)
        uniq = jnp.unique(jnp.asarray(row, jnp.int32), size=k, fill_value=99)
        np.testing.assert_array_equal(g, np.asarray(want))
        np.testing.assert_array_equal(g, np.asarray(uniq))
