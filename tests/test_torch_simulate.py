"""The port's open-loop simulator against the JAX package's.

- host tables (`make_static`, membership tables, arrival order) equal;
- the incremental snapshot builder equals the port's dense oracle;
- event by event at gate scale, the port's loop and the JAX
  `make_event_step` race the same events (t_ev, fid, is_arr) and build
  identical snapshots and edge lists;
- end to end, `get_backend("m4", device="cpu")` FCTs match the JAX `m4`
  backend at rtol 1e-5 — the bar of tests/test_simulate_incremental.py
  between kernel modes — for `run_many` on smoke16 and `run` on one
  scenario.

The gate scale is benchmarks/perf_gate.py's (h16/g16/m16/l2/SF16/SL32,
PRNGKey(0)): SF-1 = 15 takes the JAX dedupe's small-k regime, SL = 32
its sort regime.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import model as jm  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.data.traffic import sample_scenario as jax_scenario  # noqa: E402
from repro.scenarios import get_suite  # noqa: E402
from repro.sim import SimRequest as JaxRequest  # noqa: E402
from repro.sim import get_backend as jax_backend  # noqa: E402
from repro_torch.core import simulate as tsim  # noqa: E402
from repro_torch.core.model import M4Config  # noqa: E402
from repro_torch.data.traffic import sample_scenario  # noqa: E402
from repro_torch.net import FatTree, Flow, NetConfig  # noqa: E402
from repro_torch.sim import SimRequest, get_backend  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

FCT_RTOL = 1e-5
GATE = dict(hidden=16, gnn_dim=16, mlp_hidden=16, gnn_layers=2,
            snap_flows=16, snap_links=32)
SNAP_KEYS = ("snap_f", "snap_mask", "snap_l", "snap_l_mask", "edge_l",
             "edge_mask")


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


def _smoke16(num_flows):
    out = []
    for spec in get_suite("smoke16", num_flows=num_flows):
        sc = spec.to_scenario()
        out.append((sc.topo, sc.config, sc.generate()))
    return out


def test_host_tables_match_jax():
    cfg = M4Config(**GATE)
    scen = _smoke16(10)[:6]
    n_max = max(len(f) for *_, f in scen) + 3
    for pad in (False, True):
        for topo, config, flows in scen:
            k = jsim.max_link_degree(flows, cfg.max_path) + 2 * pad
            kw = dict(n_total=n_max, l_total=topo.num_links + 4,
                      k_total=k) if pad else {}
            js, jl, jideal = jsim.make_static(topo, flows, config, cfg, **kw)
            pt, pc, pf = _port(topo, config, flows)
            ts, tl, tideal = tsim.make_static(pt, pf, pc, cfg, **kw)
            assert jl == tl
            np.testing.assert_array_equal(jideal, tideal)
            for key in js:
                np.testing.assert_array_equal(np.asarray(js[key]), ts[key])
            for a, b in zip(jsim._arrival_order(js), tsim._arrival_order(ts)):
                np.testing.assert_array_equal(a, b)
            assert tsim.max_link_degree(pf, cfg.max_path) == \
                jsim.max_link_degree(flows, cfg.max_path)


@pytest.mark.parametrize("snap", [(8, 24), (16, 32), (32, 64)])
def test_incremental_builder_matches_dense_oracle(snap):
    """For arbitrary active sets (consistent occupancy bitmaps), the
    incremental builder emits what the dense oracle emits, in both dedupe
    regimes of the JAX package (SF-1 <= 16 and > 16)."""
    cfg = M4Config(**dict(GATE, snap_flows=snap[0], snap_links=snap[1]))
    for seed in range(4):
        topo, config, flows = _port(*_smoke16(12)[seed * 4][:3])
        static_np, L, _ = tsim.make_static(topo, flows, config, cfg,
                                           n_total=len(flows) + 5)
        static = tsim.stack_static([static_np], "cpu")
        N = static["flow_links"].shape[1]
        rng = np.random.default_rng(seed)
        members = static["link_members"]
        for frac in (0.0, 0.3, 0.7, 1.0):
            active = torch.from_numpy(rng.random(N) < frac)
            active[len(flows):] = False
            occ = torch.cat([active, torch.tensor([False])])[members]
            fid = torch.tensor([int(rng.integers(0, len(flows)))])
            act_d = active[None].clone()
            act_d[0, fid] = True
            got = tsim._build_snapshot(cfg, static, occ, fid)
            want = tsim._build_snapshot_dense(cfg, static["flow_links"],
                                              fid, act_d)
            for a, b in zip(got, want):
                assert torch.equal(a, b)


def _jax_events(jcfg, jp, topo, config, flows):
    """The JAX incremental open loop, one jitted `make_event_step` per
    event, recording what each event raced and built."""
    static, L, _ = jsim.make_static(topo, flows, config, jcfg)
    order, times = jsim._arrival_order(static)
    N = len(flows)
    step = jax.jit(jsim.make_event_step(jcfg, static, L))
    state = jsim.init_sim_state(jp, jcfg, static, N, L)
    big = np.float32(jsim.BIG)
    ptr, events = 0, []
    for _ in range(2 * N):
        next_arr = times[ptr] if ptr < N else big
        dep_t = np.asarray(state["t_dep"][:N])
        dep_i = int(np.argmin(dep_t))
        is_arr = bool(next_arr <= dep_t[dep_i])
        t_ev = np.float32(next_arr if is_arr else dep_t[dep_i])
        fid = int(order[min(ptr, N - 1)]) if is_arr else dep_i
        state, _, (snap_f, sfm) = step(jp, state, jnp.float32(t_ev),
                                       jnp.int32(fid), jnp.bool_(is_arr))
        snap_l, slm, el, em = jsim._build_links(
            jcfg, static["flow_links"], jnp.minimum(snap_f, N - 1), sfm, L)
        events.append((t_ev, fid, is_arr,
                       dict(zip(SNAP_KEYS, map(np.asarray, (
                           snap_f, sfm, snap_l, slm, el, em))))))
        dump = N if is_arr else fid
        state["arrived"] = state["arrived"].at[fid].set(True)
        state["done"] = state["done"].at[fid].set(not is_arr)
        state["fct"] = state["fct"].at[dump].set(t_ev - state["t_arr"][fid])
        state["t_dep"] = state["t_dep"].at[dump].set(jsim.BIG)
        ptr += is_arr
    return events, np.asarray(state["fct"][:N])


@pytest.mark.parametrize("seed", [3, 11])
def test_event_by_event_matches_jax(models, seed):
    jcfg, jp, tcfg, tp = models
    sc = jax_scenario(seed, num_flows=20)
    flows = sc.generate()
    want, jax_fct = _jax_events(jcfg, jp, sc.topo, sc.config, flows)

    topo, config, tflows = _port(sc.topo, sc.config, flows)
    static_np, L, _ = tsim.make_static(topo, tflows, config, tcfg)
    order, times = tsim._arrival_order(static_np)
    static = tsim.stack_static([static_np], "cpu")
    order = torch.from_numpy(order).long()[None]
    times = torch.from_numpy(times)[None]
    N = len(flows)
    state = tsim.init_sim_state(tp, tcfg, static, N, L)
    step = tsim.make_event_step(tcfg, static, L)
    ptr = torch.zeros(1, dtype=torch.long)
    busiest = 0
    for i, (t_ev, fid, is_arr, snap) in enumerate(want):
        state, ptr, g_t, g_fid, g_arr, g_snap = tsim._open_loop_body(
            tp, step, state, ptr, order, times)
        assert (int(g_fid[0]), bool(g_arr[0])) == (fid, is_arr), i
        np.testing.assert_allclose(float(g_t[0]), t_ev, rtol=FCT_RTOL)
        for k in SNAP_KEYS:
            np.testing.assert_array_equal(g_snap[k][0].numpy(), snap[k],
                                          err_msg=f"event {i}: {k}")
        busiest = max(busiest, int(snap["snap_mask"].sum()))
    assert busiest >= 3            # the snapshots held several live flows
    np.testing.assert_allclose(state["fct"][0, :N].numpy(), jax_fct,
                               rtol=FCT_RTOL)


def test_smoke16_run_many_matches_jax(models):
    jcfg, jp, tcfg, tp = models
    scen = _smoke16(10)
    jres = jax_backend("m4", params=jp, cfg=jcfg).run_many(
        [JaxRequest(topo=t, config=c, flows=tuple(f)) for t, c, f in scen])
    treqs = []
    for s in scen:
        t, c, f = _port(*s)
        treqs.append(SimRequest(topo=t, config=c, flows=tuple(f)))
    tres = get_backend("m4", params=tp, cfg=tcfg,
                       device="cpu").run_many(treqs)
    assert len(tres) == 16
    for a, b in zip(tres, jres):
        assert np.isfinite(a.fcts).all() and (a.fcts > 0).all()
        np.testing.assert_allclose(a.fcts, b.fcts, rtol=FCT_RTOL)
        np.testing.assert_allclose(a.slowdowns, b.slowdowns, rtol=FCT_RTOL)


def test_run_matches_jax_and_run_many(models):
    jcfg, jp, tcfg, tp = models
    sc = jax_scenario(4, num_flows=40)
    flows = sc.generate()
    jr = jax_backend("m4", params=jp, cfg=jcfg).run(
        JaxRequest(topo=sc.topo, config=sc.config, flows=tuple(flows)))
    t, c, f = _port(sc.topo, sc.config, flows)
    req = SimRequest(topo=t, config=c, flows=tuple(f))
    backend = get_backend("m4", params=tp, cfg=tcfg, device="cpu")
    tr = backend.run(req)
    np.testing.assert_allclose(tr.fcts, jr.fcts, rtol=FCT_RTOL)
    # the same scenario padded into a batch beside a larger one
    other = SimRequest.from_scenario(sample_scenario(9, num_flows=55))
    batched = backend.run_many([req, other])
    np.testing.assert_allclose(batched[0].fcts, tr.fcts, rtol=FCT_RTOL)
    with pytest.raises(NotImplementedError):
        backend.run(dataclasses.replace(req, until=1.0))
