"""The port's copies of the topology, NetConfig, Table-2 traffic generator
and SimRequest against the JAX package's: one seed, the same flows."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.data import traffic as jt  # noqa: E402
from repro.net.topology import paper_train_topo as jax_topo  # noqa: E402
from repro.sim import SimRequest as JaxRequest  # noqa: E402
from repro_torch.data import traffic as tt  # noqa: E402
from repro_torch.net import paper_train_topo  # noqa: E402
from repro_torch.sim import SimRequest  # noqa: E402

FLOW_FIELDS = ("fid", "src", "dst", "size", "t_arrival", "path")


@pytest.mark.parametrize("seed", [0, 1, 2, 7, 31])
@pytest.mark.parametrize("synthetic", [True, False])
def test_sample_scenario_generates_the_same_flows(seed, synthetic):
    js = jt.sample_scenario(seed, num_flows=300, synthetic=synthetic)
    ts = tt.sample_scenario(seed, num_flows=300, synthetic=synthetic)
    for k in ("size_dist", "theta", "sigma", "max_load", "matrix",
              "num_flows", "seed"):
        assert getattr(ts, k) == getattr(js, k), k
    assert dataclasses.asdict(ts.config) == dataclasses.asdict(js.config)
    np.testing.assert_array_equal(ts.config.feature_vec(),
                                  js.config.feature_vec())
    jf, tf = js.generate(), ts.generate()
    assert len(jf) == len(tf) == 300
    for a, b in zip(jf, tf):
        for k in FLOW_FIELDS:
            assert getattr(a, k) == getattr(b, k), (k, a.fid)
    assert (JaxRequest(topo=js.topo, config=js.config, flows=tuple(jf))
            .content_hash()
            == SimRequest.from_scenario(ts).content_hash())


@pytest.mark.parametrize("oversub", ["1-to-1", "2-to-1", "4-to-1"])
def test_topology_is_the_same(oversub):
    a, b = jax_topo(oversub), paper_train_topo(oversub)
    assert (a.num_hosts, a.num_links) == (b.num_hosts, b.num_links)
    np.testing.assert_array_equal(a.capacity, b.capacity)
    for s in range(a.num_hosts):
        for d in range(0, a.num_hosts, 5):
            assert a.path(s, d, s * d) == b.path(s, d, s * d)
            p = a.path(s, d, s + d)
            assert a.ideal_fct(12345, p) == b.ideal_fct(12345, p)


def test_point_and_sizes_draw_the_same_stream():
    for dist in [*jt.SYNTH_DISTS, *jt.EMPIRICAL, "mixed"]:
        a = jt.sample_sizes(np.random.default_rng(5), dist, 64, 9e3)
        b = tt.sample_sizes(np.random.default_rng(5), dist, 64, 9e3)
        np.testing.assert_array_equal(a, b)
    for kind in "ABC":
        np.testing.assert_array_equal(
            jt.traffic_matrix(np.random.default_rng(1), kind, 8),
            tt.traffic_matrix(np.random.default_rng(1), kind, 8))
    assert tt.TABLE2_SPACE == jt.TABLE2_SPACE
    assert (tt.sample_point(np.random.default_rng(9))
            == jt.sample_point(np.random.default_rng(9)))


def test_sim_request_canonicalises_fids():
    flows = tt.sample_scenario(0, num_flows=12).generate()
    sc = tt.sample_scenario(0, num_flows=12)
    req = SimRequest(topo=sc.topo, config=sc.config, flows=flows[::-1])
    assert [f.fid for f in req.flows] == list(range(12))
    with pytest.raises(ValueError, match="fids"):
        SimRequest(topo=sc.topo, config=sc.config, flows=flows[1:])
