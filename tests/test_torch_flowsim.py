"""The port's flowSim backends against the JAX package's.

- the numpy `run_flowsim` (the `flowsim` backend) equals JAX's bitwise,
  with `until` and `record_events`;
- `get_backend("flowsim_fast", device="cpu")` matches the JAX
  `flowsim_fast` backend at rtol 1e-5 under both kernel modes of the JAX
  package (link sums in another order), and the numpy reference at rtol
  1e-4, as tests/test_flowsim_fast.py holds JAX's;
- `run_many` equals looped `run`; `until` raises; numpy flowSim ignores
  `probes` (no series, as JAX's) and `flowsim_fast` returns a series;
  the fingerprint names the device.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")

from repro.core.flowsim import run_flowsim as jax_run_flowsim  # noqa: E402
from repro.data.traffic import sample_scenario as jax_scenario  # noqa: E402
from repro.sim import SimRequest as JaxRequest  # noqa: E402
from repro.sim import get_backend as jax_backend  # noqa: E402
from repro_torch.core import flowsim_fast as tff  # noqa: E402
from repro_torch.core.probes import ProbeConfig  # noqa: E402
from repro_torch.core.flowsim import run_flowsim  # noqa: E402
from repro_torch.data.traffic import sample_scenario  # noqa: E402
from repro_torch.net import FatTree, Flow  # noqa: E402
from repro_torch.sim import SimRequest, get_backend  # noqa: E402

FCT_RTOL = 1e-5


def _req(seed, num_flows=60, **kw):
    return SimRequest.from_scenario(sample_scenario(seed,
                                                    num_flows=num_flows), **kw)


@pytest.mark.parametrize("seed", [1, 4])
def test_numpy_flowsim_equals_jax_bitwise(seed):
    sc = sample_scenario(seed, num_flows=50)
    jsc = jax_scenario(seed, num_flows=50)
    flows, jflows = sc.generate(), jsc.generate()
    full = run_flowsim(sc.topo, flows, record_events=True)
    until = float(np.median(full.event_times))
    for kw in ({}, {"record_events": True},
               {"until": until, "record_events": True}):
        got = run_flowsim(sc.topo, flows, **kw)
        want = jax_run_flowsim(jsc.topo, jflows, **kw)
        for k in ("fcts", "slowdowns", "event_times", "event_types",
                  "event_fids"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                          err_msg=f"{kw}: {k}")
    assert np.isnan(got.fcts).any() and np.isfinite(got.fcts).any()


def test_flowsim_backend_passes_options():
    req = _req(2, num_flows=30, record_events=True)
    res = get_backend("flowsim").run(req)
    assert len(res.event_times) == 60 and np.isfinite(res.fcts).all()
    cut = get_backend("flowsim").run(dataclasses.replace(
        req, until=float(res.event_times[30])))
    assert np.isnan(cut.fcts).any()
    probed = get_backend("flowsim").run(dataclasses.replace(
        req, probes=ProbeConfig(stride=2)))
    assert probed.probes is None
    np.testing.assert_array_equal(probed.fcts, res.fcts)


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("seed", [0, 3, 7])
def test_flowsim_fast_matches_jax(seed, mode, monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", mode)
    jsc = jax_scenario(seed, num_flows=60)
    want = jax_backend("flowsim_fast").run(JaxRequest(
        topo=jsc.topo, config=jsc.config, flows=tuple(jsc.generate())))
    got = get_backend("flowsim_fast", device="cpu").run(_req(seed))
    assert np.isfinite(got.fcts).all() and (got.fcts > 0).all()
    np.testing.assert_allclose(got.fcts, want.fcts, rtol=FCT_RTOL)
    np.testing.assert_allclose(got.slowdowns, want.slowdowns, rtol=FCT_RTOL)


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_flowsim_fast_matches_numpy_reference(seed):
    req = _req(seed)
    got = get_backend("flowsim_fast", device="cpu").run(req)
    ref = run_flowsim(req.topo, list(req.flows))
    np.testing.assert_allclose(got.fcts, ref.fcts, rtol=1e-4)


def test_flowsim_fast_single_link_fair_share():
    topo = FatTree(num_racks=2, hosts_per_rack=2, num_spines=1)
    n, size = 4, 100_000
    flows = [Flow(fid=i, src=0, dst=1, size=size, t_arrival=0.0,
                  path=topo.path(0, 1, 0)) for i in range(n)]
    res = tff.run_flowsim_fast(topo, flows, device="cpu")
    np.testing.assert_allclose(res.fcts, n * size * 8.0 / 10e9, rtol=1e-5)


def test_run_many_equals_looped_run():
    reqs = [_req(s, num_flows=n) for s, n in ((0, 25), (5, 40), (2, 12),
                                               (9, 33))]
    assert len({r.topo.num_links for r in reqs}) > 1   # padded links too
    backend = get_backend("flowsim_fast", device="cpu")
    batched = backend.run_many(reqs)
    for req, b in zip(reqs, batched):
        one = backend.run(req)
        assert b.fcts.shape == (req.num_flows,)
        np.testing.assert_array_equal(b.fcts, one.fcts)


def test_event_scan_runs_32_rowmins_per_event_and_records(monkeypatch):
    """One `dispatch.waterfill_event` per event; on the CPU its plain
    version runs 32 dense rounds, one row-min each."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.waterfill import ref as wf_ref
    events, rowmins = [], []
    real_event, real_rowmin = dispatch.waterfill_event, wf_ref.masked_rowmin_ref
    monkeypatch.setattr(dispatch, "waterfill_event", lambda *a, **k:
                        events.append(1) or real_event(*a, **k))
    monkeypatch.setattr(wf_ref, "masked_rowmin_ref", lambda a, s:
                        rowmins.append(1) or real_rowmin(a, s))
    req = _req(6, num_flows=10)
    args = tff._to_device([tff._pack(req.topo, list(req.flows))], "cpu")
    fct, log = tff._event_scan_core(*args, record=True)
    assert len(events) == 2 * req.num_flows
    assert len(rowmins) == tff.MAX_ROUNDS * 2 * req.num_flows
    ev_fid, ev_arr = log["fid"], log["is_arrival"]
    assert ev_arr.shape == (1, 20) and ev_arr.sum() == req.num_flows
    # an event's rates are those of the flows active before it: none
    # before the first arrival, so no round runs there
    rounds = log["rounds"][0]
    assert rounds[0] == 0 and 0 < rounds.max() <= tff.MAX_ROUNDS
    assert rounds.dtype == torch.int32 and log["capped"].dtype == torch.bool
    assert not log["capped"].any()
    assert sorted(ev_fid[0, ev_arr[0]].tolist()) == list(range(10))
    assert sorted(ev_fid[0, ~ev_arr[0]].tolist()) == list(range(10))
    np.testing.assert_array_equal(
        fct.numpy(), tff._event_scan_core(*args).numpy())


def test_flowsim_fast_options_raise_and_fingerprint():
    backend = get_backend("flowsim_fast", device="cpu")
    assert backend.fingerprint() == "flowsim_fast_torch-ktorch"
    req = _req(1, num_flows=10)
    with pytest.raises(NotImplementedError):
        backend.run(dataclasses.replace(req, until=1.0))
    (probed,) = backend.run_many([dataclasses.replace(
        req, probes=ProbeConfig(stride=2, max_samples=4))])
    assert probed.probes["ev"].tolist() == [12, 14, 16, 18]
    assert set(probed.probes["channels"]) == {"link_active",
                                              "flow_remaining", "flow_rate"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_backend("flowsim_fast")
