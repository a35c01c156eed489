"""The plain references of `portbench/reference/` against the port's
own plain paths on the CPU, at small sizes: m4's open loop (float32 on
both sides, the same equations in another order of operations: within a
few float32 ulps) and flowSim (float32 with exact link sums: bitwise)."""
import numpy as np
import pytest

from portbench.harness import gen, lanes, weights
from portbench.harness.flows import requests
from portbench.tests.conftest import small_cell

SEEDS = [3, 2 ** 31 + 11]


def _pool(cell, seed):
    return gen.pool(cell.config, cell.traffic, seed)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("flows", [50, 150])
def test_m4_reference_matches_port(seed, flows):
    cell = small_cell("ft8-table2.m4-b8", flows=flows)
    lane = lanes.lane(cell.traffic, cell.config)
    w = weights.make(cell.config["model"], seed, "cpu")
    for batch in _pool(cell, seed):
        got = lane.backend(w, "cpu").run_many(requests(batch))
        want, counts = lane.reference(batch, w, "cpu")
        for r, ref in zip(got, want):
            np.testing.assert_allclose(r.fcts, ref, rtol=2e-6, atol=0)
        assert (counts["live_edges"] > 0).all()


def test_m4_reference_at_published_widths():
    cell = small_cell("ft8-table2.m4-b8", flows=40, batch=2)
    cell.config["model"].update(hidden=400, gnn_dim=300, mlp_hidden=200,
                                snap_flows=64, snap_links=128)
    lane = lanes.lane(cell.traffic, cell.config)
    w = weights.make(cell.config["model"], 5, "cpu")
    batch = _pool(cell, 5)[0]
    got = lane.backend(w, "cpu").run_many(requests(batch))
    want, _ = lane.reference(batch, w, "cpu")
    for r, ref in zip(got, want):
        np.testing.assert_allclose(r.fcts, ref, rtol=2e-6, atol=0)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("flows", [60, 200])
def test_flowsim_reference_matches_port_bitwise(seed, flows):
    cell = small_cell("meta-fabric.flowsim-b8", flows=flows)
    lane = lanes.lane(cell.traffic, cell.config)
    for batch in _pool(cell, seed):
        got = lane.backend(None, "cpu").run_many(requests(batch))
        want, counts = lane.reference(batch, None, "cpu")
        for r, ref in zip(got, want):
            np.testing.assert_array_equal(r.fcts, ref)
        assert counts["rounds"].shape == (2 * flows, len(batch))
        assert counts["rounds"].max() >= 1


def test_generator_is_seeded():
    cell = small_cell("ft8-table2.m4-b8", flows=80)
    a, b = _pool(cell, 77), _pool(cell, 77)
    c = _pool(cell, 78)
    for x, y, z in zip(a[0], b[0], c[0]):
        assert x.point == y.point == z.point     # the points: the mix's
        np.testing.assert_array_equal(x.t_arrival, y.t_arrival)
        assert x.paths == y.paths
        assert not np.array_equal(x.size, z.size)  # the flows: the seed's
