"""One m4 event forward (temporal GRUs, GNN, post-GNN GRUs, query heads)
of the port against the JAX package with the same weights (through the
bridge), at the gate scale of benchmarks/perf_gate.py and at the paper's
full width; tolerance 1e-5."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import model as jm  # noqa: E402
from repro.nn import mlp as jax_mlp  # noqa: E402
from repro_torch.core import model as tm  # noqa: E402
from repro_torch.nn import mlp  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

TOL = 1e-5
GATE = dict(hidden=16, gnn_dim=16, mlp_hidden=16, gnn_layers=2,
            snap_flows=16, snap_links=32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("dims", [GATE, {}], ids=["gate", "full"])
def test_one_event_forward_matches_jax(dims):
    jcfg = dataclasses.replace(jm.M4Config(**dims), kernel_mode="xla")
    tcfg = tm.M4Config(**dims)
    jp = jm.init_m4(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.device_get(jp), "cpu")
    SF, SL, P = tcfg.snap_flows, tcfg.snap_links, tcfg.max_path
    H, C, E = tcfg.hidden, tcfg.cfg_dim, SF * P
    rng = np.random.default_rng(sum(dims.values()) if dims else 1)
    x = dict(
        f_h=np.tanh(rng.normal(size=(SF, H))),
        l_h=np.tanh(rng.normal(size=(SL, H))),
        dt_f=rng.exponential(2e-5, SF), dt_l=rng.exponential(2e-5, SL),
        f_feat=rng.random((SF, 3)), l_feat=rng.random((SL, 1)),
        cfg_vec=rng.random(C), n_links=rng.integers(1, 5, SF) * 1.0,
        edge_mask=(rng.random(E) < 0.7) * 1.0)
    x = {k: v.astype(np.float32) for k, v in x.items()}
    edge_f = np.repeat(np.arange(SF), P)
    edge_l = rng.integers(0, SL, E)
    J = {k: jnp.asarray(v) for k, v in x.items()}
    T = {k: torch.from_numpy(v) for k, v in x.items()}
    je = (jnp.asarray(edge_f, jnp.int32), jnp.asarray(edge_l, jnp.int32))
    te = (torch.from_numpy(edge_f), torch.from_numpy(edge_l))

    jf, jl = jm.temporal_update(jp, jcfg, J["f_h"], J["l_h"], J["dt_f"],
                                J["dt_l"], J["f_feat"], J["l_feat"],
                                J["cfg_vec"])
    tf, tl = tm.temporal_update(tp, tcfg, T["f_h"], T["l_h"], T["dt_f"],
                                T["dt_l"], T["f_feat"], T["l_feat"],
                                T["cfg_vec"])
    _close(tf, jf)
    _close(tl, jl)

    jg = jm.gnn_forward(jp, jcfg, jf, jl, *je, J["edge_mask"])
    tg = tm.gnn_forward(tp, tcfg, tf, tl, *te, T["edge_mask"])
    for a, b in zip(tg, jg):
        _close(a, b)

    jf2, jl2 = jm.spatial_update(jp, jcfg, jf, jl, *je, J["edge_mask"],
                                 J["cfg_vec"])
    tf2, tl2 = tm.spatial_update(tp, tcfg, tf, tl, *te, T["edge_mask"],
                                 T["cfg_vec"])
    _close(tf2, jf2)
    _close(tl2, jl2)

    _close(tm.predict_sldn(tp, tf2, T["n_links"], T["cfg_vec"]),
           jm.predict_sldn(jp, jf2, J["n_links"], J["cfg_vec"]))
    _close(tm.predict_size(tp, tf2), jm.predict_size(jp, jf2))
    _close(tm.predict_queue(tp, tl2), jm.predict_queue(jp, jl2))

    fin = np.concatenate([x["f_feat"][:2], np.tile(x["cfg_vec"], (2, 1))],
                         -1)
    _close(torch.tanh(mlp(tp["flow_init"], torch.from_numpy(fin))),
           jnp.tanh(jax_mlp(jp["flow_init"], jnp.asarray(fin))))


def test_features_and_softplus_match_jax():
    dt = np.array([-1e-6, 0.0, 3e-7, 4e-5, 2.0], np.float32)
    _close(tm.time_feat(torch.from_numpy(dt)), jm.time_feat(jnp.asarray(dt)))
    size = np.array([200, 5e3, 4e6], np.float32)
    nl = np.array([2, 4, 4], np.float32)
    ideal = np.array([1e-6, 3e-5, 2e-3], np.float32)
    _close(tm.flow_static_feat(*map(torch.from_numpy, (size, nl, ideal))),
           jm.flow_static_feat(*map(jnp.asarray, (size, nl, ideal))))
    cap = np.array([10e9, 40e9], np.float32)
    _close(tm.link_static_feat(torch.from_numpy(cap)),
           jm.link_static_feat(jnp.asarray(cap)))
    # beyond torch's softplus threshold (20) the JAX form still adds e^-x
    v = np.array([-30.0, -1.0, 0.0, 5.0, 19.0, 25.0, 60.0], np.float32)
    _close(tm.softplus(torch.from_numpy(v)),
           jax.nn.softplus(jnp.asarray(v)))
