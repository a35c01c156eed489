"""The port's teacher-forced losses (`repro_torch.core.training`) and its
training step against the JAX package's, on the CPU, at the training
layout of tests/test_train.py (hidden 16, GNN 12, MLP 8, 2 rounds, SF 8,
SL 24) with 12-20 flows and 32 events per sim, weights from JAX's
`init_m4` through `params_from_jax`:

- each head's loss at rtol 1e-5, with and without `dense_sldn`; the
  gradient of every leaf at rtol 1e-4 with atol 1e-6 x the leaf's max |g|
  (float32 sums of K events' chains in other orders);
- one AdamW update of the trainer from the same weights and batch;
- the plain path: `plain=True` routes the GRU pair and the GNN to their
  plain versions on any device and gives every leaf a gradient; the
  kernels refuse inputs that require grad;
- padding a sim into a bucket keeps its losses (tests/test_train.py:118).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.events import EventBatch as JaxEventBatch  # noqa: E402
from repro.core.model import M4Config as JaxM4Config  # noqa: E402
from repro.core.model import init_m4 as jax_init  # noqa: E402
from repro.core.training import _as_jnp  # noqa: E402
from repro.core.training import event_scan_losses as jax_losses  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train.loop import _sim_loss as jax_sim_loss  # noqa: E402
from repro.train.loop import make_bucket_step as jax_bucket_step  # noqa: E402
from repro_torch.core import model as tm  # noqa: E402
from repro_torch.core.events import build_event_batch  # noqa: E402
from repro_torch.core.training import combined_loss  # noqa: E402
from repro_torch.core.training import event_scan_losses  # noqa: E402
from repro_torch.data.traffic import sample_scenario  # noqa: E402
from repro_torch.kernels.bipartite import ops as bip_ops  # noqa: E402
from repro_torch.kernels.fused_gru import ops as gru_ops  # noqa: E402
from repro_torch.kernels.waterfill import ops as wf_ops  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.sim import SimRequest, get_backend  # noqa: E402
from repro_torch.train import TrainConfig, stack_bucket  # noqa: E402
from repro_torch.train.loop import _make_schedule  # noqa: E402
from repro_torch.train.loop import make_bucket_step  # noqa: E402
from repro_torch.weights import (params_from_jax, tree_leaves,  # noqa: E402
                                 tree_map)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL_FRAC = 1e-6
TINY = dict(hidden=16, gnn_dim=12, mlp_hidden=8, gnn_layers=2,
            snap_flows=8, snap_links=24)
MAX_EVENTS = 32


def _tensors(batch) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.to_arrays().items()}


@pytest.fixture(scope="module")
def batches():
    """Four sims of diverse footprints: 12-20 flows, 32 events each."""
    out = []
    for seed, n in ((0, 12), (1, 14), (2, 16), (3, 20)):
        req = SimRequest.from_scenario(sample_scenario(seed, num_flows=n))
        trace = get_backend("packet").run(req).raw
        out.append(build_event_batch(trace, tm.M4Config(**TINY),
                                     max_events=MAX_EVENTS))
    return out


@pytest.fixture(scope="module")
def weights():
    jp = jax_init(jax.random.PRNGKey(0), JaxM4Config(**TINY))
    return jp, params_from_jax(jax.device_get(jp), "cpu")


def _jax_cfg(dense):
    return JaxM4Config(**TINY, dense_sldn=dense, kernel_mode="xla")


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "departures"])
def test_losses_and_gradients_match_jax(batches, weights, dense):
    jp, tp = weights
    b = batches[3]
    jb = _as_jnp(JaxEventBatch.from_arrays(b.to_arrays()))
    jcfg, tcfg = _jax_cfg(dense), tm.M4Config(**TINY, dense_sldn=dense)
    want = jax_losses(jp, jcfg, jb)

    leaves = tree_map(lambda p: p.clone().requires_grad_(), tp)
    total, got = combined_loss(leaves, tcfg, _tensors(b))
    for head in ("size", "queue", "sldn"):
        np.testing.assert_allclose(float(got[head].detach()),
                                   float(want[head]), rtol=LOSS_RTOL,
                                   err_msg=head)
    total.backward()

    jg = jax.grad(lambda p: sum(jax_losses(p, jcfg, jb).values()))(jp)
    jflat = dict(tree_leaves(jax.device_get(jg)))
    for path, leaf in tree_leaves(leaves):
        g, w = leaf.grad.numpy(), jflat[path]
        assert np.abs(w).max() > 0, path
        np.testing.assert_allclose(
            g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL_FRAC * np.abs(w).max(),
            err_msg=path)


def test_one_adamw_update_matches_jax(batches, weights):
    """One per-sim update of the trainer (clip, then AdamW at lr 1e-3)
    from the same weights and batch. Tolerance: the loss at rtol 1e-5.
    AdamW's first step is lr * g / (|g| + eps) per element, about
    lr * sign(g): where a gradient is well determined (|g| above 1e-3 of
    its leaf's max) the two updates agree at rtol 1e-3; where it is near
    zero, its sign is within float32 noise, and the two updates may
    differ by up to 2 lr, but by no more."""
    jp, tp = weights
    lr = 1e-3
    b = batches[3]
    jtc = JaxTrainConfig(lr=lr, schedule="const")
    jstep = jax_bucket_step(_jax_cfg(True), jtc, lambda s: jnp.float32(lr))
    jb = {k: jnp.asarray(v)[None] for k, v in b.to_arrays().items()}
    jnew, jopt, jouts = jstep(jp, jax_adamw_init(jp), jb)

    tc = TrainConfig(lr=lr, schedule="const")
    step = make_bucket_step(tm.M4Config(**TINY), tc, _make_schedule(tc, 1))
    tb = {k: v[None] for k, v in _tensors(b).items()}
    tnew, topt, touts = step(tp, adamw_init(tp), tb)

    assert int(topt["step"]) == int(jopt["step"]) == 1
    np.testing.assert_allclose(touts.numpy(), np.asarray(jouts),
                               rtol=LOSS_RTOL)
    g = dict(tree_leaves(jax.device_get(jax.grad(
        lambda p: jax_sim_loss(p, _jax_cfg(True), jtc,
                               _as_jnp(JaxEventBatch.from_arrays(
                                   b.to_arrays())))[0])(jp))))
    old, want = dict(tree_leaves(tp)), dict(tree_leaves(jax.device_get(jnew)))
    for path, leaf in tree_leaves(tnew):
        d_got = leaf.numpy() - old[path].numpy()
        d_want = want[path] - old[path].numpy()
        big = np.abs(g[path]) > 1e-3 * np.abs(g[path]).max()
        np.testing.assert_allclose(d_got[big], d_want[big], rtol=1e-3,
                                   err_msg=path)
        assert np.abs(d_got - d_want).max() <= 2 * lr * (1 + 1e-3), path


def test_padding_preserves_per_sim_losses(batches, weights):
    _, tp = weights
    assert len({b.footprint for b in batches}) > 1, "want diverse shapes"
    cfg = tm.M4Config(**TINY)
    lv = event_scan_losses(tp, cfg, stack_bucket(batches))
    for i, b in enumerate(batches):
        li = event_scan_losses(tp, cfg, _tensors(b))
        for head in li:
            np.testing.assert_allclose(float(lv[head][i]), float(li[head]),
                                       rtol=2e-5, err_msg=f"sim {i} {head}")


def test_every_param_leaf_gets_gradient(batches, weights):
    """Dense supervision reaches every parameter, and ablating a head's
    loss weight zeroes exactly that head (tests/test_train.py:183)."""
    _, tp = weights
    cfg = tm.M4Config(**TINY)

    def grads(**w):
        leaves = tree_map(lambda p: p.clone().requires_grad_(), tp)
        combined_loss(leaves, cfg, _tensors(batches[0]), **w)[0].backward()
        return leaves

    dead = [p for p, l in tree_leaves(grads())
            if not (l.grad is not None and torch.isfinite(l.grad).all()
                    and l.grad.abs().max() > 0)]
    assert not dead, f"param leaves with zero gradient: {dead}"
    g0 = grads(w_size=0.0)
    assert all(l.grad.abs().max() == 0 for _, l in
               tree_leaves(g0["mlp_size"]))
    assert any(l.grad.abs().max() > 0 for _, l in
               tree_leaves(g0["mlp_queue"]))


def _meta_event(cfg, requires_grad):
    """One event's inputs on the meta device: neither CPU nor CUDA, so
    only the keyword keeps them off the kernels."""
    p = tm.init_m4(0, cfg, device="meta")
    if requires_grad:
        p = tree_map(lambda t: t.requires_grad_(), p)
    SF, SL, P, H = cfg.snap_flows, cfg.snap_links, cfg.max_path, cfg.hidden

    def m(*shape):
        return torch.empty(*shape, device="meta")
    edges = (torch.arange(SF, device="meta").repeat_interleave(P),
             torch.zeros(SF * P, dtype=torch.long, device="meta"),
             m(SF * P))
    return p, (m(SF, H), m(SL, H), m(SF), m(SL), m(SF, 3), m(SL, 1),
               m(cfg.cfg_dim)), edges


def test_plain_keyword_routes_to_the_plain_versions(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("a kernel was called")
    monkeypatch.setattr(gru_ops, "gru_pair", no_kernel)
    monkeypatch.setattr(bip_ops, "bipartite_rounds", no_kernel)
    cfg = tm.M4Config(**TINY)
    p, (f_h, l_h, dt_f, dt_l, f_feat, l_feat, cv), edges = \
        _meta_event(cfg, True)
    f, l = tm.temporal_update(p, cfg, f_h, l_h, dt_f, dt_l, f_feat, l_feat,
                              cv, plain=True)
    f2, l2 = tm.spatial_update(p, cfg, f, l, *edges, cv, plain=True)
    assert f2.shape == f_h.shape and l2.shape == l_h.shape
    assert f2.grad_fn is not None and l2.grad_fn is not None
    # without the keyword, tensors that are not on the CPU go to the
    # kernels
    with pytest.raises(AssertionError, match="a kernel was called"):
        tm.temporal_update(p, cfg, f_h, l_h, dt_f, dt_l, f_feat, l_feat, cv)


def test_kernels_refuse_inputs_that_require_grad():
    cfg = tm.M4Config(**TINY)
    p, (f_h, l_h, dt_f, dt_l, f_feat, l_feat, cv), edges = \
        _meta_event(cfg, True)
    with pytest.raises(RuntimeError, match="plain=True"):
        tm.temporal_update(p, cfg, f_h, l_h, dt_f, dt_l, f_feat, l_feat, cv)
    with pytest.raises(RuntimeError, match="plain=True"):
        tm.gnn_forward(p, cfg, f_h, l_h, *edges)
    x = torch.ones(4, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="plain=True"):
        wf_ops.masked_rowmin(x[None], torch.ones(1, 3))
    with pytest.raises(RuntimeError, match="plain=True"):
        wf_ops.waterfill_event(None, x, torch.ones(1, 4, dtype=torch.bool))
    # without grad mode the refusal steps aside, and the device check
    # speaks (the kernels take CUDA tensors)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        tm.temporal_update(p, cfg, f_h, l_h, dt_f, dt_l, f_feat, l_feat, cv)

