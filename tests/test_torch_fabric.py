"""The paper's §5.2 topology, `meta_fabric`, in the port against the JAX
package's:

- `repro_torch.net.meta_fabric` builds the JAX package's fabric: hosts,
  racks, spines, links, capacities and propagation delays bitwise, the
  ECMP paths of a seeded sample of host pairs and flow ids, and
  `ideal_fct`, for the defaults (6144 hosts, 18432 links), another
  oversubscription and a cut-down fabric;
- the port's `sample_scenario(seed, topo=meta_fabric())` draws the JAX
  package's flows;
- m4 on the default fabric at 40 flows (gate-scale `M4Config`, 2 GNN
  rounds) gives JAX's FCTs at rtol 1e-5 plus one float32 ulp of the
  completion time (m4's clock is float32);
- `flowsim_fast` on `meta_fabric(num_pods=2, racks_per_pod=2,
  hosts_per_rack=4)` at 60 flows gives JAX's FCTs at rtol 1e-5, the bar
  of the 8-rack parity test (tests/test_torch_flowsim.py), under both
  kernel modes of the JAX package.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")

from repro.core import model as jm  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.data.traffic import sample_scenario as jax_scenario  # noqa: E402
from repro.net import topology as jtopo  # noqa: E402
from repro.sim import SimRequest as JaxRequest  # noqa: E402
from repro.sim import get_backend as jax_backend  # noqa: E402
from repro_torch.core.model import M4Config  # noqa: E402
from repro_torch.data.traffic import sample_scenario  # noqa: E402
from repro_torch.net import meta_fabric  # noqa: E402
from repro_torch.sim import SimRequest, get_backend  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

FCT_RTOL = 1e-5
GATE = dict(hidden=16, gnn_dim=16, mlp_hidden=16, gnn_layers=2,
            snap_flows=16, snap_links=32)
SMALL = dict(num_pods=2, racks_per_pod=2, hosts_per_rack=4)
FABRICS = {"default": {}, "oversub_4to1": {"oversub": "4-to-1"},
           "oversub_1to1_small": dict(SMALL, oversub="1-to-1"),
           "small": SMALL}


@pytest.mark.parametrize("name", sorted(FABRICS))
def test_meta_fabric_equals_jax(name):
    kw = FABRICS[name]
    got, want = meta_fabric(**kw), jtopo.meta_fabric(**kw)
    for k in ("num_racks", "hosts_per_rack", "num_spines", "link_gbps",
              "prop_delay_s", "oversub", "num_hosts", "num_links"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.capacity.tobytes() == want.capacity.tobytes()
    assert got.prop.tobytes() == want.prop.tobytes()
    rng = np.random.default_rng(0)
    n = got.num_hosts
    for src, dst, fid in zip(rng.integers(0, n, 500), rng.integers(0, n, 500),
                             rng.integers(0, 10 ** 6, 500)):
        path = got.path(int(src), int(dst), int(fid))
        assert path == want.path(int(src), int(dst), int(fid))
        assert all(0 <= l < got.num_links for l in path)
        for size in (1000, 1 << 20):
            assert got.ideal_fct(size, path) == want.ideal_fct(size, path)


def test_default_fabric_is_the_papers_scale():
    t = meta_fabric()
    assert (t.num_hosts, t.num_racks, t.num_spines, t.num_links) == \
        (6144, 384, 8, 18432)


def _jax_request(seed, num_flows, kw):
    sc = jax_scenario(seed, num_flows=num_flows,
                      topo=jtopo.meta_fabric(**kw))
    return JaxRequest(topo=sc.topo, config=sc.config,
                      flows=tuple(sc.generate()))


def _port_request(seed, num_flows, kw):
    return SimRequest.from_scenario(sample_scenario(
        seed, num_flows=num_flows, topo=meta_fabric(**kw)))


@pytest.mark.parametrize("seed", [0, 5])
def test_fabric_scenario_draws_jax_flows(seed):
    got, want = _port_request(seed, 200, {}), _jax_request(seed, 200, {})
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
    assert [(f.fid, f.src, f.dst, f.size, f.t_arrival, list(f.path))
            for f in got.flows] == \
        [(f.fid, f.src, f.dst, f.size, f.t_arrival, list(f.path))
         for f in want.flows]


def _assert_fcts_close(got, want, flows):
    """FCTs (and slowdowns, the FCTs over each flow's ideal) within rtol
    plus one float32 ulp of each flow's completion time."""
    arr = np.array([f.t_arrival for f in flows])
    ulp = np.spacing(np.float32(arr + want.fcts)).astype(np.float64)
    assert (np.abs(got.fcts - want.fcts)
            <= FCT_RTOL * np.abs(want.fcts) + ulp).all()
    ideal = want.fcts / want.slowdowns
    assert (np.abs(got.slowdowns - want.slowdowns)
            <= FCT_RTOL * np.abs(want.slowdowns) + ulp / ideal).all()


def test_m4_on_meta_fabric_matches_jax():
    jcfg = jsim.canonicalize_cfg(jm.M4Config(**GATE))
    jp = jm.init_m4(jax.random.PRNGKey(0), jcfg)
    jreq = _jax_request(3, 40, {})
    want = jax_backend("m4", params=jp, cfg=jcfg).run(jreq)
    req = _port_request(3, 40, {})
    assert req.topo.num_links == 18432
    got = get_backend("m4", params=params_from_jax(jax.device_get(jp), "cpu"),
                      cfg=M4Config(**GATE), device="cpu").run(req)
    assert np.isfinite(got.fcts).all() and (got.fcts > 0).all()
    _assert_fcts_close(got, want, req.flows)


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("seed", [0, 3])
def test_flowsim_fast_on_small_fabric_matches_jax(seed, mode, monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", mode)
    want = jax_backend("flowsim_fast").run(_jax_request(seed, 60, SMALL))
    got = get_backend("flowsim_fast", device="cpu").run(
        _port_request(seed, 60, SMALL))
    assert np.isfinite(got.fcts).all() and (got.fcts > 0).all()
    np.testing.assert_allclose(got.fcts, want.fcts, rtol=FCT_RTOL)
    np.testing.assert_allclose(got.slowdowns, want.slowdowns, rtol=FCT_RTOL)
