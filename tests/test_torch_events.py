"""The port's `EventBatch` / `build_event_batch` and `packet` backend
against the JAX package's: from the same scenario, every field of the
event tensors bitwise (dtype and bytes), for the training layout of
tests/test_train.py and the paper's full snapshot layout; and the
`packet` backend's `SimResult` equal to the JAX `packet` backend's."""
import dataclasses

import numpy as np
import pytest

# one torch thread: the suite's xdist workers share the host's cores
pytest.importorskip("torch").set_num_threads(1)
pytest.importorskip("jax")

from repro.core.events import EventBatch as JaxEventBatch  # noqa: E402
from repro.core.events import build_event_batch as jax_build  # noqa: E402
from repro.core.model import M4Config as JaxM4Config  # noqa: E402
from repro.net import packetsim as jps  # noqa: E402
from repro.net.topology import FatTree as JaxFatTree  # noqa: E402
from repro.sim import SimRequest as JaxRequest  # noqa: E402
from repro.sim import get_backend as jax_backend  # noqa: E402
from repro_torch.core.events import EventBatch, build_event_batch  # noqa: E402
from repro_torch.core.model import M4Config  # noqa: E402
from repro_torch.data.traffic import sample_scenario  # noqa: E402
from repro_torch.sim import SimRequest, get_backend  # noqa: E402

TINY = dict(hidden=16, gnn_dim=12, mlp_hidden=8, gnn_layers=2,
            snap_flows=8, snap_links=24)


def _jax_request(req: SimRequest) -> JaxRequest:
    t = req.topo
    return JaxRequest(
        topo=JaxFatTree(t.num_racks, t.hosts_per_rack, t.num_spines,
                        t.link_gbps, t.prop_delay_s, t.oversub),
        config=jps.NetConfig(**dataclasses.asdict(req.config)),
        flows=tuple(jps.Flow(f.fid, f.src, f.dst, f.size, f.t_arrival,
                             list(f.path)) for f in req.flows),
        until=req.until, seed=req.seed, record_events=req.record_events)


@pytest.fixture(scope="module")
def traces():
    out = {}
    for seed in (0, 1, 3):
        req = SimRequest.from_scenario(sample_scenario(seed, num_flows=40),
                                       seed=seed, record_events=True)
        out[seed] = (req, get_backend("packet").run(req),
                     jax_backend("packet").run(_jax_request(req)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_packet_backend_equals_jax(traces, seed):
    _, got, want = traces[seed]
    assert got.backend == want.backend == "packet"
    for name in ("fcts", "slowdowns", "event_times", "event_types",
                 "event_fids"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert got.event_remaining == want.event_remaining
    assert got.event_queues == want.event_queues
    assert np.isfinite(got.fcts).all()


@pytest.mark.parametrize("seed,layout,max_events", [
    (0, TINY, 32), (1, TINY, None), (3, TINY, 17), (1, {}, None),
    (3, {}, 50)], ids=["tiny-32", "tiny-all", "tiny-17", "full-all",
                       "full-50"])
def test_event_batch_equals_jax_bitwise(traces, seed, layout, max_events):
    _, got, want = traces[seed]
    tb = build_event_batch(got.raw, M4Config(**layout), max_events=max_events)
    jb = jax_build(want.raw, JaxM4Config(**layout), max_events=max_events)
    ta, ja = tb.to_arrays(), jb.to_arrays()
    assert list(ta) == list(ja)          # same fields, same order
    for k in ja:
        assert ta[k].dtype == ja[k].dtype, k
        assert ta[k].shape == ja[k].shape, k
        assert ta[k].tobytes() == ja[k].tobytes(), k
    assert tb.footprint == jb.footprint
    assert tb.rem_mask.sum() > 0 and tb.queue_mask.sum() > 0


@pytest.mark.parametrize("k", [1, 17, 32])
def test_head_equals_a_build_cut_to_k_events(traces, k):
    _, got, _ = traces[1]
    whole = build_event_batch(got.raw, M4Config(**TINY))
    cut = build_event_batch(got.raw, M4Config(**TINY), max_events=k)
    a, b = whole.head(k).to_arrays(), cut.to_arrays()
    assert list(a) == list(b)
    for n in b:
        assert a[n].shape == b[n].shape and a[n].tobytes() == b[n].tobytes(), n


def test_arrays_round_trip_between_packages(traces):
    _, got, _ = traces[0]
    tb = build_event_batch(got.raw, M4Config(**TINY), max_events=32)
    back = EventBatch.from_arrays(JaxEventBatch.from_arrays(
        tb.to_arrays()).to_arrays())
    for k, v in tb.to_arrays().items():
        assert v.tobytes() == back.to_arrays()[k].tobytes(), k
    with pytest.raises(KeyError):
        EventBatch.from_arrays({**tb.to_arrays(), "bogus": np.zeros(1)})
