"""The port's probes against the JAX package's, on the CPU.

- `ProbeConfig` and `normalize_probes` accept, reject and canonicalise
  exactly as JAX's do;
- `finalize` on the same raw numpy rings (a wrapped ring, a partly
  written one, padded slots at t >= BIG/2) equals JAX's bitwise;
- m4 at gate scale (h16/g16/m16/l2/SF16/SL32, JAX's PRNGKey(0) weights
  carried across by `repro_torch.weights`), probed at stride 3 with a
  ring of 8 so it wraps: `ev` equal exactly, `t` and every channel at
  rtol 1e-5 (the bar of the open loop's FCTs); FCTs equal the unprobed
  run's bitwise;
- `flowsim_fast` probed at 60 flows: `ev` exact, `t` and channels at
  rtol 1e-5 against JAX's; FCTs equal the unprobed run's bitwise. Its
  remaining bytes are a flow's size less what it has drained, and JAX
  sums link loads in float32 in XLA's order where the port sums exactly
  (ROADMAP, Queue 3), so near a flow's end the cancellation lifts the
  relative error of the remainder: there the bound is 1e-5 of the flow's
  size (`size_atol`), the same rtol taken on the quantity that drains;
- a padded `run_many` trims each scenario's series to its own flows and
  links as JAX's batch path does (rtol 1e-5), and mixed probes raise;
- flowsim_fast's active flows per link, a scatter-add over the rows,
  equal the product of the active set with the dense arena of the same
  paths bitwise, on random active sets and in a probed batch's series;
- the packet DES's series equals JAX's bitwise; numpy `flowsim` returns
  no series; `content_hash` ignores probes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")

from repro.core import flowsim_fast as jff  # noqa: E402
from repro.core import model as jm  # noqa: E402
from repro.core import probes as jpr  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.data.traffic import sample_scenario as jax_scenario  # noqa: E402
from repro.scenarios import get_suite as jax_suite  # noqa: E402
from repro.sim import SimRequest as JaxRequest  # noqa: E402
from repro.sim import get_backend as jax_backend  # noqa: E402
from repro_torch.core import flowsim_fast as tff  # noqa: E402
from repro_torch.core import probes as tpr  # noqa: E402
from repro_torch.core.compiled import Program  # noqa: E402
from repro_torch.core.model import M4Config  # noqa: E402
from repro_torch.data.traffic import sample_scenario  # noqa: E402
from repro_torch.net import FatTree, Flow, NetConfig  # noqa: E402
from repro_torch.obs import validate_series  # noqa: E402
from repro_torch.sim import SimRequest, get_backend  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

RTOL = 1e-5
GATE = dict(hidden=16, gnn_dim=16, mlp_hidden=16, gnn_layers=2,
            snap_flows=16, snap_links=32)
WRAP = dict(stride=3, max_samples=8)


@pytest.fixture(scope="module")
def models():
    jcfg = jsim.canonicalize_cfg(jm.M4Config(**GATE))
    jp = jm.init_m4(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, M4Config(**GATE), params_from_jax(jax.device_get(jp),
                                                       "cpu")


def _port(topo, config, flows):
    """The JAX package's scenario records as the port's."""
    t = FatTree(topo.num_racks, topo.hosts_per_rack, topo.num_spines,
                topo.link_gbps, topo.prop_delay_s, topo.oversub)
    c = NetConfig(**dataclasses.asdict(config))
    return t, c, [Flow(f.fid, f.src, f.dst, f.size, f.t_arrival,
                       list(f.path)) for f in flows]


def _series_close(got, want, rtol=RTOL, sizes=None):
    """`sizes` (bytes per flow): flow_remaining also passes within rtol
    of its flow's size."""
    assert got["schema"] == want["schema"] == tpr.SCHEMA_TS
    assert (got["stride"], got["max_samples"]) == \
        (want["stride"], want["max_samples"])
    np.testing.assert_array_equal(got["ev"], want["ev"])
    np.testing.assert_allclose(got["t"], want["t"], rtol=rtol)
    assert list(got["channels"]) == list(want["channels"])
    for ch, v in got["channels"].items():
        w = want["channels"][ch]
        assert v.shape == w.shape, ch
        if ch == "flow_remaining" and sizes is not None:
            bad = np.abs(v - w) > rtol * np.abs(w) + rtol * sizes[None, :]
            assert not bad.any(), (ch, np.argwhere(bad)[:5])
        else:
            np.testing.assert_allclose(v, w, rtol=rtol, err_msg=ch)
    assert got["meta"] == want["meta"]


def _series_equal(got, want):
    for k in ("schema", "stride", "max_samples", "meta"):
        assert got[k] == want[k], k
    for k in ("t", "ev"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert list(got["channels"]) == list(want["channels"])
    for ch, v in got["channels"].items():
        assert v.dtype == want["channels"][ch].dtype
        np.testing.assert_array_equal(v, want["channels"][ch], err_msg=ch)


# ------------------------------------------------------------ ProbeConfig
@pytest.mark.parametrize("kw", [
    {}, {"stride": 4, "max_samples": 16},
    {"channels": ("flow_rate", "link_queue", "flow_rate")},
    {"channels": ("flow_remaining",)}, {"channels": ()},
    {"stride": 0}, {"max_samples": 0}, {"channels": ("queue",)},
    {"stride": -3, "channels": ("link_active",)}])
def test_probe_config_accepts_and_rejects_as_jax(kw):
    def make(cls):
        try:
            return cls(**kw), None
        except ValueError as e:
            return None, str(e)
    got, gerr = make(tpr.ProbeConfig)
    want, werr = make(jpr.ProbeConfig)
    assert gerr == werr
    if got is None:
        return
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got == tpr.ProbeConfig(**dataclasses.asdict(got))
    assert hash(got) == hash(tpr.ProbeConfig(**dataclasses.asdict(got)))
    for supported in (tpr.CHANNELS, tpr.M4_CHANNELS, tpr.FLOWSIM_CHANNELS,
                      ("link_active", "flow_remaining"), ("nothing",)):
        g = tpr.normalize_probes(got, supported)
        w = jpr.normalize_probes(want, supported)
        assert (g is None) == (w is None)
        if g is not None:
            assert dataclasses.astuple(g) == dataclasses.astuple(w)
    assert tpr.normalize_probes(None) is None
    assert (tpr.CHANNELS, tpr.M4_CHANNELS, tpr.FLOWSIM_CHANNELS,
            tpr.SCHEMA_TS, tpr.BIG) == (jpr.CHANNELS, jpr.M4_CHANNELS,
                                        jpr.FLOWSIM_CHANNELS, jpr.SCHEMA_TS,
                                        jpr.BIG)


# --------------------------------------------------------------- finalize
def _raw_rings(kind, probes, N, L, seed):
    """Raw numpy rings as a run leaves them: `wrapped` (every slot
    written, the oldest mid-ring), `partial` (unwritten slots at -1) and
    `padded` (a padded scenario's trailing events at t = BIG)."""
    rng = np.random.default_rng(seed)
    S = probes.max_samples
    hits = {"wrapped": S + 5, "partial": S - 3, "padded": S + 2}[kind]
    ev = np.full(S, -1, np.int32)
    t = np.zeros(S, np.float32)
    times = np.sort(rng.uniform(0, 1e-2, hits)).astype(np.float32)
    if kind == "padded":
        times[-4:] = np.float32(tpr.BIG)
    for k in range(hits):
        ev[k % S], t[k % S] = k * probes.stride, times[k]
    bufs = {"t": t, "ev": ev}
    for ch in probes.channels:
        D = L if ch in tpr.LINK_CHANNELS else N
        bufs[ch] = rng.standard_normal((S, D)).astype(np.float32)
    return bufs


@pytest.mark.parametrize("kind", ["wrapped", "partial", "padded"])
@pytest.mark.parametrize("trim", [None, (7, 5)])
def test_finalize_equals_jax_bitwise(kind, trim):
    N, L = 11, 9
    tp = tpr.ProbeConfig(stride=3, max_samples=10)
    jp = jpr.ProbeConfig(stride=3, max_samples=10)
    bufs = _raw_rings(kind, tp, N, L, seed=len(kind))
    kw = dict(num_flows=N, num_links=L)
    if trim:
        kw.update(trim_flows=trim[0], trim_links=trim[1])
    got = tpr.finalize(tp, bufs, **kw)
    want = jpr.finalize(jp, bufs, **kw)
    _series_equal(got, want)
    assert validate_series(got) == []
    if kind == "wrapped":
        assert len(got["ev"]) == 10 and np.all(np.diff(got["ev"]) > 0)
    if kind == "padded":
        assert len(got["ev"]) == 10 - 4


def test_record_writes_ring_slots_on_stride_hits():
    p = tpr.ProbeConfig(stride=2, max_samples=3, channels=("flow_rate",))
    bufs = tpr.init_buffers(p, batch=2, num_flows=4, num_links=5,
                            device="cpu")
    assert bufs["ev"].dtype == torch.int32 and (bufs["ev"] == -1).all()
    assert set(bufs) == {"t", "ev", "flow_rate"}
    assert bufs["flow_rate"].shape == (2, 3, 4)
    calls, k = [], [-1]
    hits = torch.zeros((), dtype=torch.long)

    def event():
        k[0] += 1
        return torch.full((2,), k[0] * 0.5)

    def value():
        calls.append(k[0])
        return torch.full((2, 4), float(k[0]))
    # the loops' programs: an event, its sample, stride - 1 more events
    prog = Program(load=None, event=event, result=None, length=9,
                   stride=p.stride, sample=lambda t: tpr.record(
                       p, bufs, hits, t, {"flow_rate": value}))
    assert prog.plan == [("group", 4), ("tail", 1)]
    prog.run_eager()
    # the read-out runs on stride hits only
    assert calls == [0, 2, 4, 6, 8] and int(hits) == 5
    # hits 0..4 -> slots 0, 1, 2, 0, 1
    assert bufs["ev"].tolist() == [[6, 8, 4]] * 2
    assert bufs["flow_rate"][:, :, 0].tolist() == [[6.0, 8.0, 4.0]] * 2
    series = tpr.finalize(p, {k: v[1].numpy() for k, v in bufs.items()},
                          num_flows=4, num_links=5)
    assert series["ev"].tolist() == [4, 6, 8]
    assert series["t"].tolist() == [2.0, 3.0, 4.0]


# ---------------------------------------------------------------- m4
def _m4_pair(models, seed, num_flows, **probe_kw):
    jcfg, jp, tcfg, tp = models
    sc = jax_scenario(seed, num_flows=num_flows)
    flows = sc.generate()
    jres = jsim.simulate_open_loop(jp, jcfg, sc.topo, sc.config, flows,
                                   probes=jpr.ProbeConfig(**probe_kw))
    t, c, f = _port(sc.topo, sc.config, flows)
    req = SimRequest(topo=t, config=c, flows=tuple(f))
    backend = get_backend("m4", params=tp, cfg=tcfg, device="cpu")
    return req, backend, jres


@pytest.mark.parametrize("seed", [0, 5])
def test_m4_probed_run_matches_jax(models, seed):
    req, backend, jres = _m4_pair(models, seed, 50, **WRAP)
    probed = backend.run(dataclasses.replace(
        req, probes=tpr.ProbeConfig(**WRAP)))
    s = probed.probes
    # 100 events, hits at 0, 3, ..., 99: 34 hits, the last 8 kept
    assert s["ev"].tolist() == list(range(78, 100, 3))
    assert s["meta"]["backend"] == "m4"
    assert validate_series(s) == []
    assert set(s["channels"]) == set(tpr.M4_CHANNELS)
    _series_close(s, jres.probes)
    np.testing.assert_allclose(probed.fcts, jres.fcts, rtol=RTOL)
    unprobed = backend.run(req)
    assert probed.fcts.tobytes() == unprobed.fcts.tobytes()


def test_m4_probed_channel_subset(models):
    req, backend, jres = _m4_pair(models, 2, 40, stride=5, max_samples=64,
                                  channels=("link_active", "flow_rate"))
    s = backend.run(dataclasses.replace(req, probes=tpr.ProbeConfig(
        stride=5, max_samples=64,
        channels=("link_active", "flow_rate")))).probes
    # flow_rate is no m4 channel: only link_active is recorded
    assert list(s["channels"]) == ["link_active"]
    assert s["ev"].tolist() == list(range(0, 80, 5))
    _series_close(s, jres.probes)
    # a request whose channels m4 cannot record takes no probes at all
    none = backend.run(dataclasses.replace(req, probes=tpr.ProbeConfig(
        channels=("flow_rate",))))
    assert none.probes is None


def test_m4_run_many_trims_per_scenario_as_jax(models):
    jcfg, jp, tcfg, tp = models
    scen = []
    for spec in list(jax_suite("smoke16", num_flows=10))[:3]:
        sc = spec.to_scenario()
        scen.append((sc.topo, sc.config, sc.generate()))
    jout = jsim.simulate_open_loop_batch(jp, jcfg, scen,
                                         probes=jpr.ProbeConfig(**WRAP))
    p = tpr.ProbeConfig(**WRAP)
    reqs = []
    for s in scen:
        t, c, f = _port(*s)
        reqs.append(SimRequest(topo=t, config=c, flows=tuple(f), probes=p))
    backend = get_backend("m4", params=tp, cfg=tcfg, device="cpu")
    tout = backend.run_many(reqs)
    sizes = {(len(r.flows), r.topo.num_links) for r in reqs}
    assert len(sizes) == 3            # padding matters
    for r, got, want in zip(reqs, tout, jout):
        s = got.probes
        assert s["channels"]["flow_remaining"].shape[1] == len(r.flows)
        assert s["channels"]["link_queue"].shape[1] == r.topo.num_links
        assert np.all(s["t"] < tpr.BIG / 2)
        _series_close(s, want.probes)
    with pytest.raises(ValueError, match="uniform `probes`"):
        backend.run_many([reqs[0], dataclasses.replace(reqs[1],
                                                       probes=None)])


# ---------------------------------------------------------- flowsim_fast
@pytest.mark.parametrize("seed", [0, 3])
def test_flowsim_fast_probed_matches_jax(seed):
    sc = jax_scenario(seed, num_flows=60)
    flows = sc.generate()
    jres = jff.run_flowsim_fast(sc.topo, flows,
                                probes=jpr.ProbeConfig(stride=4,
                                                       max_samples=16))
    req = SimRequest.from_scenario(sample_scenario(seed, num_flows=60))
    backend = get_backend("flowsim_fast", device="cpu")
    probed = backend.run(dataclasses.replace(
        req, probes=tpr.ProbeConfig(stride=4, max_samples=16)))
    s = probed.probes
    assert s["ev"].tolist() == list(range(56, 120, 4))
    assert list(s["channels"]) == list(tpr.FLOWSIM_CHANNELS)
    assert validate_series(s) == []
    size_atol = np.array([f.size for f in flows], np.float64)
    _series_close(s, jres.probes, sizes=size_atol)
    unprobed = backend.run(req)
    assert probed.fcts.tobytes() == unprobed.fcts.tobytes()


def test_flowsim_fast_run_many_trims_and_refuses_mixed_probes():
    p = tpr.ProbeConfig(stride=2, max_samples=512)
    reqs = [SimRequest.from_scenario(sample_scenario(s, num_flows=n),
                                     probes=p)
            for s, n in ((1, 20), (4, 33))]
    backend = get_backend("flowsim_fast", device="cpu")
    batched = backend.run_many(reqs)
    for r, got in zip(reqs, batched):
        alone = backend.run(r).probes
        s = got.probes
        assert s["channels"]["flow_rate"].shape == (r.num_flows, r.num_flows)
        assert s["channels"]["link_active"].shape[1] == r.topo.num_links
        # the padded scenario's own events are all kept, its padding not
        assert s["ev"].tolist() == list(range(0, 2 * r.num_flows, 2))
        _series_close(s, alone)
    with pytest.raises(ValueError, match="uniform `probes`"):
        backend.run_many([reqs[0], dataclasses.replace(reqs[1],
                                                       probes=None)])


def _fs_batch(seeds_flows, more_links=0):
    """Scenarios, the rows `_pack` writes for them padded to one shape,
    and the dense (B, N, L) arena of the same paths."""
    scs = [sample_scenario(s, num_flows=n) for s, n in seeds_flows]
    scenarios = [(sc.topo, sc.generate()) for sc in scs]
    N = max(len(flows) for _, flows in scenarios)
    L = max(topo.num_links for topo, _ in scenarios) + more_links
    args = tff._to_device([tff._pack(topo, flows, n_total=N, l_total=L)
                           for topo, flows in scenarios], "cpu")
    a = np.zeros((len(scs), N, L), np.float32)
    for b, (_, flows) in enumerate(scenarios):
        for f in flows:
            a[b, f.fid, f.path] = 1.0
    return scenarios, args, torch.from_numpy(a)


def test_flowsim_fast_link_active_equals_the_dense_product():
    _, args, a = _fs_batch(((0, 40), (5, 25), (2, 12)), more_links=3)
    B, N, L = a.shape
    links = tff._pad_rows(args[0], tff._list_width(args[0].shape[2]))
    rng = np.random.default_rng(7)
    for p in (0.0, 0.3, 0.7, 1.0):
        active = torch.from_numpy(rng.random((B, N)) < p)
        got = tff._link_active(links, active, L)
        want = torch.bmm(active.float()[:, None], a)[:, 0]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.numpy().tobytes() == want.numpy().tobytes()


def test_flowsim_fast_batch_link_active_series_is_the_dense_product():
    """A probed `run_flowsim_fast_batch` on the CPU: each sample of
    `link_active` is the active set after its event times the dense arena,
    the active sets read from a recording run of the same arenas."""
    stride = 3
    scenarios, args, a = _fs_batch(((1, 20), (4, 33)))
    res = tff.run_flowsim_fast_batch(
        scenarios, device="cpu",
        probes=tpr.ProbeConfig(stride=stride, max_samples=512))
    _, log = tff._event_scan_core(*args, record=True)
    fid, arr = log["fid"].numpy(), log["is_arrival"].numpy()
    B, N, L = a.shape
    active = np.zeros((B, N), bool)
    want = []
    for e in range(fid.shape[1]):
        active[np.arange(B), fid[:, e]] = arr[:, e]
        if e % stride == 0:
            want.append(torch.bmm(torch.from_numpy(active).float()[:, None],
                                  a)[:, 0].numpy())
    for b, ((topo, flows), r) in enumerate(zip(scenarios, res)):
        s = r.probes
        assert s["ev"].tolist() == list(range(0, 2 * len(flows), stride))
        exp = np.stack([want[e // stride][b, :topo.num_links]
                        for e in s["ev"]])
        np.testing.assert_array_equal(s["channels"]["link_active"], exp)


# ------------------------------------------------------- host backends
@pytest.mark.parametrize("probe_kw", [
    dict(stride=3, max_samples=8),
    dict(stride=1, max_samples=1000, channels=("flow_remaining",))])
def test_packet_series_equals_jax_bitwise(probe_kw):
    sc = jax_scenario(6, num_flows=30)
    jres = jax_backend("packet").run(JaxRequest(
        topo=sc.topo, config=sc.config, flows=tuple(sc.generate()),
        probes=jpr.ProbeConfig(**probe_kw)))
    req = SimRequest.from_scenario(sample_scenario(6, num_flows=30),
                                   probes=tpr.ProbeConfig(**probe_kw))
    got = get_backend("packet").run(req)
    _series_equal(got.probes, jres.probes)
    assert validate_series(got.probes) == []


def test_flowsim_returns_no_series_and_hash_ignores_probes():
    req = SimRequest.from_scenario(sample_scenario(3, num_flows=20))
    probed = dataclasses.replace(req, probes=tpr.ProbeConfig())
    res = get_backend("flowsim").run(probed)
    assert res.probes is None
    np.testing.assert_array_equal(res.fcts,
                                  get_backend("flowsim").run(req).fcts)
    assert probed.content_hash() == req.content_hash()
    assert dataclasses.replace(
        req, probes=tpr.ProbeConfig(stride=7)).content_hash() \
        == req.content_hash()
