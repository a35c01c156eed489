"""The port's closed loop (§5.4) against the JAX package's.

- `make_backlog` draws the same flows from one seed in both packages;
- `run_closed_loop` with the port's `flowsim` (the numpy FlowSimSession)
  equals the JAX package's bitwise, and `flowsim_fast` opens that same
  session, as in JAX;
- the port's `M4Simulator` matches the JAX one through `run_closed_loop`
  at rtol 1e-5 (the bar of tests/test_torch_simulate.py) with weights
  carried across by `params_from_jax` at the gate scale;
- the two closed-loop tests of tests/test_simulate_incremental.py,
  mirrored: an idle arena answers (None, None), and a flow's occupancy
  slots are set on arrival and cleared on departure.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")

from repro.core import model as jm  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.core.closedloop import make_backlog as jax_backlog  # noqa: E402
from repro.net.packetsim import NetConfig as JaxNetConfig  # noqa: E402
from repro.net.topology import FatTree as JaxFatTree  # noqa: E402
from repro.sim import get_backend as jax_backend  # noqa: E402
from repro.sim import run_closed_loop as jax_closed_loop  # noqa: E402
from repro_torch.core import simulate as tsim  # noqa: E402
from repro_torch.core.closedloop import make_backlog  # noqa: E402
from repro_torch.core.model import M4Config  # noqa: E402
from repro_torch.net import FatTree, NetConfig  # noqa: E402
from repro_torch.sim import FlowSimSession, get_backend  # noqa: E402
from repro_torch.sim import run_closed_loop  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

FCT_RTOL = 1e-5
GATE = dict(hidden=16, gnn_dim=16, mlp_hidden=16, gnn_layers=2,
            snap_flows=16, snap_links=32)
FLOW_FIELDS = ("fid", "src", "dst", "size", "t_arrival", "path")


@pytest.fixture(scope="module")
def models():
    jcfg = jsim.canonicalize_cfg(jm.M4Config(**GATE))
    jp = jm.init_m4(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, M4Config(**GATE), params_from_jax(jax.device_get(jp),
                                                       "cpu")


def _backlogs(flows_per_rack=10, seed=3, size_dist="WebServer"):
    kw = dict(client_racks=2, flows_per_rack=flows_per_rack,
              size_dist=size_dist, seed=seed)
    jt, tt = JaxFatTree(8, 4, 2), FatTree(8, 4, 2)
    jb, tb = jax_backlog(jt, **kw), make_backlog(tt, **kw)
    return jt, jb, tt, tb


def test_make_backlog_equals_jax():
    for size_dist in ("WebServer", "lognormal"):
        _, jb, _, tb = _backlogs(flows_per_rack=12, seed=5,
                                 size_dist=size_dist)
        assert [len(r) for r in tb] == [len(r) for r in jb] == [12, 12]
        for jr, tr in zip(jb, tb):
            for jf, tf in zip(jr, tr):
                assert [getattr(tf, k) for k in FLOW_FIELDS] == \
                    [getattr(jf, k) for k in FLOW_FIELDS]


@pytest.mark.parametrize("inflight", [1, 3])
def test_flowsim_closed_loop_equals_jax_bitwise(inflight):
    jt, jb, tt, tb = _backlogs()
    want = jax_closed_loop(jax_backend("flowsim"), jt, JaxNetConfig(), jb,
                           inflight)
    for name, kw in (("flowsim", {}), ("flowsim_fast", {"device": "cpu"})):
        got = run_closed_loop(get_backend(name, **kw), tt, NetConfig(), tb,
                              inflight)
        assert np.isfinite(got.completion_times).all()
        np.testing.assert_array_equal(got.completion_times,
                                      want.completion_times)
        assert (got.makespan, got.throughput) == (want.makespan,
                                                  want.throughput)
    assert isinstance(get_backend("flowsim_fast", device="cpu").closed_loop(
        tt, NetConfig(), [f for r in tb for f in r]), FlowSimSession)


def test_m4_closed_loop_matches_jax(models):
    jcfg, jp, tcfg, tp = models
    jt, jb, tt, tb = _backlogs()
    want = jax_closed_loop(jax_backend("m4", params=jp, cfg=jcfg), jt,
                           JaxNetConfig(), jb, 3)
    got = run_closed_loop(get_backend("m4", params=tp, cfg=tcfg,
                                      device="cpu"), tt, NetConfig(), tb, 3)
    assert np.isfinite(got.completion_times).all()
    assert np.isfinite(want.completion_times).all()
    np.testing.assert_allclose(got.completion_times, want.completion_times,
                               rtol=FCT_RTOL)
    np.testing.assert_allclose(got.throughput, want.throughput,
                               rtol=FCT_RTOL)


def _session(tp, tcfg, n=8):
    tt, tb = _backlogs(flows_per_rack=n)[2:]
    flows = [f for r in tb for f in r]
    return tsim.M4Simulator(tp, tcfg, tt, NetConfig(), flows)


def test_next_departure_scalars_and_idle(models):
    *_, tcfg, tp = models
    s = _session(tp, tcfg)
    assert s.next_departure() == (None, None)          # idle arena
    s.inject_arrival(0, 0.0)
    t, i = s.next_departure()
    assert isinstance(t, float) and t > 0 and i == 0
    s.commit_departure(i, t)
    assert s.next_departure() == (None, None)
    assert np.isfinite(s.fcts[0])
    ct = s.completion_times()
    assert ct[0] == t and np.isnan(ct[1:]).all()


def test_closed_loop_occupancy_tracks_active(models):
    """After arrival the flow occupies its links' slots; after departure
    the slots clear again."""
    *_, tcfg, tp = models
    s = _session(tp, tcfg)
    rows = s.static["occ_rows"][0, 0].numpy()
    slots = s.static["occ_slots"][0, 0].numpy()
    live = rows < s.num_links
    assert live.any()
    s.inject_arrival(0, 0.0)
    occ = s.state["link_occ"][0].numpy()
    assert occ[rows[live], slots[live]].all()
    assert s.state["arrived"][0, 0] and not s.state["done"][0, 0]
    t, i = s.next_departure()
    s.commit_departure(0, t)
    occ = s.state["link_occ"][0].numpy()
    assert not occ[rows[live], slots[live]].any()
    assert s.state["done"][0, 0] and s.state["t_dep"][0, 0] == tsim.BIG


def test_closed_loop_sessions_without_support_raise():
    from repro_torch.sim.backends import Backend
    with pytest.raises(NotImplementedError):
        Backend().closed_loop(FatTree(2, 2, 1), NetConfig(), [])
