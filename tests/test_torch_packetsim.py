"""The port's packet DES (`repro_torch.net.packetsim`) against the JAX
package's: from the same flows, topology, config and seed, the same
`Trace` bit for bit — every event record (time, kind, flow, active set,
remaining sizes, path queues), every flow's runtime state and FCT.

Seeds of the Table-2 generator cover DCTCP, DCQCN (whose ECN marking
draws from the DES's own generator) and TIMELY, and 1-to-1, 2-to-1 and
4-to-1 oversubscription; a `until` cut is checked besides.
"""
import dataclasses

import pytest

# one torch thread: the suite's xdist workers share the host's cores
pytest.importorskip("torch").set_num_threads(1)
pytest.importorskip("jax")

from repro.net import packetsim as jps  # noqa: E402
from repro.net.topology import FatTree as JaxFatTree  # noqa: E402
from repro_torch.data.traffic import sample_scenario  # noqa: E402
from repro_torch.net import packetsim as tps  # noqa: E402


# 4-to-1 DCQCN, 2-to-1 DCQCN, 4-to-1 DCTCP, 4-to-1 TIMELY, 2-to-1 TIMELY,
# 1-to-1 DCTCP, 1-to-1 DCQCN
SEEDS = [0, 1, 2, 4, 9, 11, 35]


def _jax_side(topo, config, flows):
    """The port's scenario records as the JAX package's."""
    t = JaxFatTree(topo.num_racks, topo.hosts_per_rack, topo.num_spines,
                   topo.link_gbps, topo.prop_delay_s, topo.oversub)
    c = jps.NetConfig(**dataclasses.asdict(config))
    return t, c, [jps.Flow(f.fid, f.src, f.dst, f.size, f.t_arrival,
                           list(f.path)) for f in flows]


def _runs(scenario, seed=0, until=None):
    config = scenario.config
    flows = scenario.generate()
    jt, jc, jf = _jax_side(scenario.topo, config, flows)
    want = jps.PacketSim(jt, jc, seed=seed).run(jf, until=until)
    got = tps.PacketSim(scenario.topo, config, seed=seed).run(flows,
                                                              until=until)
    return got, want


def _assert_same_trace(got, want):
    assert len(got.events) > 0
    assert len(got.events) == len(want.events)
    for i, (a, b) in enumerate(zip(got.events, want.events)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b), f"event {i}"
        assert type(a.time) is type(b.time), f"event {i}"
    fields = [f.name for f in dataclasses.fields(jps.Flow)]
    for a, b in zip(got.flows, want.flows):
        assert [getattr(a, k) for k in fields] == \
            [getattr(b, k) for k in fields], f"flow {a.fid}"
    assert got.fcts.tobytes() == want.fcts.tobytes()


def test_generator_covers_the_configs():
    seen = {(sample_scenario(s).topo.oversub, sample_scenario(s).config.cc)
            for s in SEEDS}
    assert {o for o, _ in seen} == {"1-to-1", "2-to-1", "4-to-1"}
    assert {c for _, c in seen} == {"dctcp", "dcqcn", "timely"}


@pytest.mark.parametrize("seed", SEEDS)
def test_trace_equals_jax_bitwise(seed):
    got, want = _runs(sample_scenario(seed, num_flows=60), seed=seed)
    _assert_same_trace(got, want)
    assert all(f.done for f in got.flows)


def test_cut_trace_equals_jax_bitwise():
    sc = sample_scenario(1, num_flows=60)
    flows = sc.generate()
    until = sorted(f.t_arrival for f in flows)[30]
    got, want = _runs(sc, until=until)
    _assert_same_trace(got, want)
    assert not all(f.done for f in got.flows)
