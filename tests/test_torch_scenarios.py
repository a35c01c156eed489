"""The port's sweep layer (`repro_torch.scenarios`) and the sim-layer
pieces under it, against the JAX package on the same seeds, on the CPU:

- the workload families (`table2` with every size distribution,
  `incast`, `permutation`, `all_to_all`) give bitwise the JAX flows;
- `check_result_finite` raises on the same inputs as JAX's;
- the packet closed loop (`PacketSession`) gives bitwise JAX's
  completion times;
- every suite builds JAX's specs, and every spec JAX's request
  (`content_hash`), at small `num_flows`; `divergence_worst` reads a
  report; `Sweep`'s grid, limit and `+` and the dict round trip;
- `run_chunked` returns results in input order, equal to `run_many`;
- a `smoke16` sweep through `SweepRunner` matches JAX's `SweepRunner`:
  `flowsim` bitwise, `flowsim_fast` and m4 (test width) at rtol 1e-5,
  the bar of tests/test_torch_simulate.py; a re-run is all hits. m4's
  clock is float32 and an FCT is the difference of two of its readings,
  so m4 is held at rtol 1e-5 on completion times, and on FCTs up to one
  float32 ulp of the completion time (a short flow that ends at 4 ms
  carries 4.7e-10 s of clock resolution: 4e-5 of an 11 µs FCT);
- caches are shared where the backends are: a JAX-written (zstd) packet
  cache serves the port's runner as hits, and a port-written entry serves
  JAX's.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")

from repro.core import model as jm  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.core.closedloop import make_backlog as jax_backlog  # noqa: E402
from repro.data import traffic as jtraffic  # noqa: E402
from repro.net.topology import FatTree as JaxFatTree  # noqa: E402
from repro.runtime import guards as jguards  # noqa: E402
from repro.scenarios import SweepRunner as JaxRunner  # noqa: E402
from repro.scenarios import get_suite as jax_suite  # noqa: E402
from repro.scenarios.spec import spec_to_dict as jax_spec_to_dict  # noqa: E402
from repro.net.packetsim import NetConfig as JaxNetConfig  # noqa: E402
from repro.sim import SimResult as JaxResult  # noqa: E402
from repro.sim import get_backend as jax_backend  # noqa: E402
from repro.sim import run_closed_loop as jax_closed_loop  # noqa: E402
from repro_torch.core.closedloop import make_backlog  # noqa: E402
from repro_torch.core.model import M4Config  # noqa: E402
from repro_torch.data import traffic  # noqa: E402
from repro_torch.net import FatTree, NetConfig  # noqa: E402
from repro_torch.runtime import guards  # noqa: E402
from repro_torch.scenarios import (ScenarioSpec, Sweep,  # noqa: E402
                                   SweepRunner, get_suite, list_suites,
                                   result_key, spec_from_dict, spec_to_dict)
from repro_torch.sim import SimResult, get_backend  # noqa: E402
from repro_torch.sim import run_closed_loop  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

FCT_RTOL = 1e-5
GATE = dict(hidden=16, gnn_dim=16, mlp_hidden=16, gnn_layers=2,
            snap_flows=16, snap_links=32)
TOPOS = [(8, 4, 2), (4, 2, 2), (4, 4, 2)]


def _flows(flows):
    return [(f.fid, f.src, f.dst, f.size, f.t_arrival.hex()
             if isinstance(f.t_arrival, float) else f.t_arrival,
             tuple(f.path)) for f in flows]


# ------------------------------------------------------ workload families
@pytest.mark.parametrize("workload", ["table2", "incast", "permutation",
                                      "all_to_all"])
def test_workload_families_equal_jax(workload):
    dists = ["lognormal", "WebServer", "mixed", "pareto", "Hadoop"]
    for i, (r, h, s) in enumerate(TOPOS):
        for seed in (0, 11, 503):
            kw = dict(size_dist=dists[(i + seed) % len(dists)],
                      theta=25e3, sigma=1.0 + seed % 2, max_load=0.45,
                      matrix="ABC"[seed % 3], num_flows=37, seed=seed,
                      workload=workload, fan_in=3 + seed % 6,
                      participants=2 + seed % 7)
            want = jtraffic.Scenario(topo=JaxFatTree(r, h, s),
                                     config=JaxNetConfig(), **kw).generate()
            got = traffic.Scenario(topo=FatTree(r, h, s), config=NetConfig(),
                                   **kw).generate()
            assert len(got) == 37
            assert _flows(got) == _flows(want), (workload, r, h, s, seed)
    assert sorted(traffic.WORKLOADS) == sorted(jtraffic.WORKLOADS)
    with pytest.raises(ValueError, match="unknown workload"):
        traffic.Scenario(topo=FatTree(4, 2, 2), config=NetConfig(),
                         workload="ring").generate()


# ------------------------------------------------------- result guard
def test_check_result_finite_raises_as_jax(monkeypatch):
    def res(fcts, cls):
        fcts = np.asarray(fcts, float)
        return cls(fcts=fcts, slowdowns=fcts, wall_time=0.0)
    cases = [[1.0, 2.0], [1.0, np.nan], [np.nan, np.nan], [1.0, np.inf],
             [np.nan, -np.inf], []]
    for enabled in ("", "1"):
        monkeypatch.setenv("REPRO_CHECK_FINITE", enabled)
        for case in cases:
            outcome = []
            for mod, cls in ((jguards, JaxResult), (guards, SimResult)):
                try:
                    mod.check_result_finite("x", res(case, cls))
                    outcome.append(None)
                except AssertionError as exc:
                    outcome.append(str(exc))
            assert outcome[0] == outcome[1], case
            assert (outcome[0] is not None) == (
                enabled == "1" and case not in ([1.0, 2.0], [1.0, np.nan],
                                                [])), case


# ---------------------------------------------------- packet closed loop
def test_packet_closed_loop_equals_jax():
    for topo_args, kw in (((8, 4, 2), dict(client_racks=2, flows_per_rack=12,
                                          size_dist="WebServer", seed=0)),
                          ((4, 2, 2), dict(client_racks=1, flows_per_rack=15,
                                          size_dist="Hadoop", seed=3))):
        want = jax_closed_loop(jax_backend("packet"), JaxFatTree(*topo_args),
                               JaxNetConfig(), jax_backlog(
                                   JaxFatTree(*topo_args), **kw), 3)
        got = run_closed_loop(get_backend("packet"), FatTree(*topo_args),
                              NetConfig(), make_backlog(FatTree(*topo_args),
                                                        **kw), 3)
        assert np.isfinite(got.completion_times).all()
        assert got.completion_times.tobytes() == \
            want.completion_times.tobytes()
        assert (got.makespan, got.throughput) == (want.makespan,
                                                  want.throughput)


# ------------------------------------------------------------------ suites
SMALL = {"table1_paper": dict(num_flows=20),
         "table3_empirical": dict(num_flows=20),
         "table4_scaling": dict(flows_base=16),
         "table2_train_space": dict(n=6, num_flows=20),
         "table2_grid": dict(num_flows=12),
         "beyond_paper": dict(num_flows=24),
         "smoke16": dict(num_flows=10)}


def test_every_suite_equals_jax(tmp_path):
    report = tmp_path / "report.json"
    worst = [jax_spec_to_dict(s) for s in jax_suite("beyond_paper",
                                                    num_flows=24)][:5]
    report.write_text(json.dumps({"worst_specs": worst}))
    knobs = dict(SMALL, divergence_worst=dict(report=str(report), k=4,
                                              num_flows=18))
    assert sorted(knobs) == list_suites()
    for name, kw in knobs.items():
        mine, theirs = get_suite(name, **kw), jax_suite(name, **kw)
        assert mine.name == theirs.name and len(mine) == len(theirs) > 0
        for a, b in zip(mine, theirs):
            assert spec_to_dict(a) == jax_spec_to_dict(b), name
            assert a.label == b.label
            for seed in (0, 5):
                assert a.to_request(seed=seed).content_hash() == \
                    b.to_request(seed=seed).content_hash(), (name, a.label)
    assert len(get_suite("divergence_worst", report=str(report))) == 5
    report.write_text(json.dumps({"worst_specs": []}))
    with pytest.raises(ValueError, match="worst_specs"):
        get_suite("divergence_worst", report=str(report))
    with pytest.raises(KeyError):
        get_suite("table9")


def test_specs_sweeps_and_their_dicts():
    base = ScenarioSpec(num_flows=12, workload="incast", fan_in=5)
    g = Sweep.grid("g", base, cc=["dctcp", "timely"], max_load=[0.3, 0.6])
    assert len(g) == 4 and g.specs[1].name == "g[dctcp/0.6]"
    assert (g + g.limit(1)).name == "g+g" and len(g + g.limit(1)) == 5
    for s in list(g) + list(get_suite("table2_train_space", n=3)):
        assert spec_from_dict(json.loads(json.dumps(spec_to_dict(s)))) == s
    with pytest.raises(ValueError, match="unknown spec fields"):
        Sweep.grid("bad", base, colour=["red"])
    with pytest.raises(ValueError, match="unknown ScenarioSpec fields"):
        spec_from_dict({"colour": "red"})
    with pytest.raises(ValueError, match="unknown workload"):
        ScenarioSpec(workload="ring")
    # the fan-in and participant knobs shape the flows, not the hash
    # formula: specs that generate the same flows share one request hash
    a = dataclasses.replace(base, workload="table2", fan_in=5)
    b = dataclasses.replace(base, workload="table2", fan_in=9)
    assert a.to_request().content_hash() == b.to_request().content_hash()


def test_run_chunked_keeps_input_order():
    specs = list(get_suite("smoke16", num_flows=8))[::-1][:7]
    reqs = [s.to_request() for s in specs]
    fs = get_backend("flowsim")
    whole = fs.run_many(reqs)
    for chunk in (None, 1, 3, 7, 100):
        got = fs.run_chunked(reqs, chunk)
        assert [r.fcts.tobytes() for r in got] == \
            [r.fcts.tobytes() for r in whole], chunk
    with pytest.raises(ValueError):
        fs.run_chunked(reqs, 0)


# ------------------------------------------------------------------ sweeps
@pytest.fixture(scope="module")
def smoke():
    return get_suite("smoke16"), jax_suite("smoke16")


def _assert_close(rep, jrep, rtol, clock_ulp=False):
    assert [e.spec.label for e in rep.entries] == \
        [e.spec.label for e in jrep.entries]
    for e, j in zip(rep.entries, jrep.entries):
        assert np.isfinite(e.result.fcts).all()
        if rtol == 0:
            assert e.result.fcts.tobytes() == j.result.fcts.tobytes(), \
                e.spec.label
            continue
        a, b = e.result.fcts, j.result.fcts
        if not clock_ulp:
            np.testing.assert_allclose(a, b, rtol=rtol, err_msg=e.spec.label)
            continue
        arr = np.array([f.t_arrival for f in e.request.flows])
        np.testing.assert_allclose(arr + a, arr + b, rtol=rtol,
                                   err_msg=e.spec.label)
        ulp = np.spacing(np.float32(arr + b)).astype(np.float64)
        assert (np.abs(a - b) <= rtol * np.abs(b) + ulp).all(), e.spec.label


def test_flowsim_sweep_bitwise_and_cached(smoke, tmp_path):
    mine, theirs = smoke
    runner = SweepRunner(get_backend("flowsim"), cache_dir=str(tmp_path))
    rep = runner.run(mine)
    jrep = JaxRunner(jax_backend("flowsim"), chunk_size=8).run(theirs)
    assert (rep.hits, rep.misses) == (0, 16)
    _assert_close(rep, jrep, 0)
    again = runner.run(mine)
    assert (again.hits, again.misses) == (16, 0) and again.simulate_s == 0.0
    for a, b in zip(again.entries, rep.entries):
        assert a.result.fcts.tobytes() == b.result.fcts.tobytes()
    assert "16 cached / 0 simulated" in again.table()


def test_flowsim_fast_sweep_matches_jax(smoke):
    mine, theirs = smoke
    rep = SweepRunner(get_backend("flowsim_fast", device="cpu"),
                      chunk_size=8).run(mine)
    jrep = JaxRunner(jax_backend("flowsim_fast"), chunk_size=8).run(theirs)
    _assert_close(rep, jrep, FCT_RTOL)


def test_m4_sweep_matches_jax(smoke):
    mine, theirs = smoke
    jcfg = jsim.canonicalize_cfg(jm.M4Config(**GATE))
    jp = jm.init_m4(jax.random.PRNGKey(0), jcfg)
    m4 = get_backend("m4", params=params_from_jax(jax.device_get(jp), "cpu"),
                     cfg=M4Config(**GATE), device="cpu")
    rep = SweepRunner(m4, chunk_size=8).run(mine)
    jrep = JaxRunner(jax_backend("m4", params=jp, cfg=jcfg),
                     chunk_size=8).run(theirs)
    _assert_close(rep, jrep, FCT_RTOL, clock_ulp=True)


# ----------------------------------------------------------- shared caches
def test_packet_cache_is_shared_with_jax(tmp_path):
    mine = get_suite("table3_empirical", num_flows=25)
    theirs = jax_suite("table3_empirical", num_flows=25)
    zstd_dir, zlib_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jrep = JaxRunner(jax_backend("packet"), cache_dir=zstd_dir).run(theirs)
    req = mine.specs[0].to_request()
    assert result_key(req, get_backend("packet")) == \
        result_key(req, jax_backend("packet"))
    # JAX wrote zstd (zstandard is installed here): the port reads hits
    rep = SweepRunner(get_backend("packet"), cache_dir=zstd_dir).run(mine)
    assert (rep.hits, rep.misses) == (3, 0)
    _assert_close(rep, jrep, 0)
    # a port-written (zlib) cache serves JAX's runner
    fresh = SweepRunner(get_backend("packet"), cache_dir=zlib_dir).run(mine)
    assert fresh.misses == 3
    back = JaxRunner(jax_backend("packet"), cache_dir=zlib_dir).run(theirs)
    assert (back.hits, back.misses) == (3, 0)
    _assert_close(fresh, back, 0)
    _assert_close(fresh, jrep, 0)
