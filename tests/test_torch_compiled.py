"""The compiled event loops (`repro_torch.core.compiled`) against the JAX
package's jit cache, on the CPU.

- `TRACE_COUNTS`: over one sequence of calls (`run` twice at one shape,
  `run` at a second shape, `run_many` of 3 padded to one shape,
  `run_chunked`, a `SweepRunner` sweep of smoke16 specs, and a second
  backend with fresh weights of the same config), each step moves the
  port's counters exactly as it moves JAX's, for m4 and flowsim_fast,
  both caches cold at the start;
- the dense program (`snapshot_impl="dense"`) against JAX's dense
  program: FCTs at rtol 1e-5, `run` and batched; its own cache key;
- `warmup=True` reports the cold first call as `compile_wall` and
  returns the warm call's FCTs, bitwise;
- the program's steps: one event, or an event, its sample and
  `stride - 1` events, plus a tail;
- `eager()` runs uncached and uncounted, bitwise as the cached run;
  `record=True` is uncounted; `clear_compiled` drops entries;
- the card's incidence lists padded to a program's width give the
  kernel's arithmetic (the numpy emulation of
  tests/test_torch_waterfill_event.py) the same rates, bitwise.

Gate widths (h16/g16/m16/l2/SF16/SL32, PRNGKey(0)), 8-12 flows.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")

from repro.core import flowsim_fast as jff  # noqa: E402
from repro.core import model as jm  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.scenarios import ScenarioSpec as JaxSpec  # noqa: E402
from repro.scenarios import SweepRunner as JaxRunner  # noqa: E402
from repro.scenarios import get_suite as jax_suite  # noqa: E402
from repro.sim import get_backend as jax_backend  # noqa: E402
from repro_torch.core import compiled  # noqa: E402
from repro_torch.core import flowsim_fast as tff  # noqa: E402
from repro_torch.core import simulate as tsim  # noqa: E402
from repro_torch.core.model import M4Config  # noqa: E402
from repro_torch.core.probes import FLOWSIM_CHANNELS  # noqa: E402
from repro_torch.core.probes import ProbeConfig, normalize_probes  # noqa: E402
from repro_torch.kernels.waterfill import layout  # noqa: E402
from repro_torch.scenarios import ScenarioSpec, SweepRunner  # noqa: E402
from repro_torch.scenarios import get_suite  # noqa: E402
from repro_torch.sim import get_backend  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

FCT_RTOL = 1e-5
GATE = dict(hidden=16, gnn_dim=16, mlp_hidden=16, gnn_layers=2,
            snap_flows=16, snap_links=32)


@pytest.fixture(scope="module")
def models():
    jcfg = jsim.canonicalize_cfg(jm.M4Config(**GATE))
    jp = jm.init_m4(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, M4Config(**GATE), params_from_jax(jax.device_get(jp),
                                                       "cpu")


def _reqs(spec, n, seeds, topo="ft-4x2x2"):
    return [spec(topo=topo, num_flows=n, seed=s, max_load=0.4).to_request()
            for s in seeds]


def _pair(models, name, fresh=False):
    """(JAX backend, port backend, JAX counters, port counters)."""
    jcfg, jp, tcfg, tp = models
    if name == "flowsim_fast":
        return (jax_backend(name), get_backend(name, device="cpu"),
                jff.TRACE_COUNTS, tff.TRACE_COUNTS)
    if fresh:
        jp = jm.init_m4(jax.random.PRNGKey(7), jcfg)
        tp = params_from_jax(jax.device_get(jp), "cpu")
    return (jax_backend("m4", params=jp, cfg=jcfg),
            get_backend("m4", params=tp, cfg=tcfg, device="cpu"),
            jsim.TRACE_COUNTS, tsim.TRACE_COUNTS)


def _moved(counts, fn):
    """(the counters fn() moved, by how much; fn's value)."""
    before = dict(counts)
    value = fn()
    return {k: v - before.get(k, 0) for k, v in counts.items()
            if v != before.get(k, 0)}, value


def _delta(counts, fn):
    return _moved(counts, fn)[0]


@pytest.mark.parametrize("name", ["m4", "flowsim_fast"])
def test_trace_counts_move_as_jax(models, name, tmp_path):
    jb, tb, jc, tc = _pair(models, name)
    jb2, tb2, _, _ = _pair(models, name, fresh=True)
    steps = [
        ("run", lambda b, S, R: b.run(_reqs(S, 8, [0])[0])),
        ("run, same shape", lambda b, S, R: b.run(_reqs(S, 8, [0])[0])),
        ("run, second shape", lambda b, S, R: b.run(_reqs(S, 10, [0])[0])),
        ("run_many of 3", lambda b, S, R: b.run_many(
            _reqs(S, 8, [0]) + _reqs(S, 10, [1]) + _reqs(S, 9, [2]))),
        ("run_chunked", lambda b, S, R: b.run_chunked(
            _reqs(S, 8, [3, 4, 5]) + _reqs(S, 12, [6]), 2)),
        ("sweep", lambda b, S, R: R(b, chunk_size=4).run(
            (jax_suite if S is JaxSpec else get_suite)(
                "smoke16", num_flows=8).limit(4))),
    ]
    jax.clear_caches()
    compiled.clear_compiled()
    moved = []
    for label, fn in steps:
        want = _delta(jc, lambda: fn(jb, JaxSpec, JaxRunner))
        got = _delta(tc, lambda: fn(tb, ScenarioSpec, SweepRunner))
        assert got == want, label
        moved.append(sum(got.values()))
    assert moved[0] == 1 and moved[1] == 0 and moved[2] == 1
    assert sum(moved) >= 5
    # fresh weights of the same config reuse every program, in both
    for label, fn in steps[:4]:
        assert _delta(jc, lambda: fn(jb2, JaxSpec, JaxRunner)) == {}, label
        assert _delta(tc, lambda: fn(tb2, ScenarioSpec, SweepRunner)) == {}


def _scenario(seed, n):
    """One JAX request and the port's request of the same spec."""
    kw = dict(topo="ft-4x2x2", num_flows=n, seed=seed, max_load=0.4)
    return JaxSpec(**kw).to_request(), ScenarioSpec(**kw).to_request()


def test_dense_program_matches_jax(models):
    jcfg, jp, tcfg, tp = models
    pairs = [_scenario(s, n) for s, n in ((0, 10), (1, 8), (2, 12))]
    jr, tr = zip(*pairs)
    jw = jsim.simulate_open_loop(jp, jcfg, jr[0].topo, jr[0].config,
                                 list(jr[0].flows), snapshot_impl="dense")
    before = dict(tsim.TRACE_COUNTS)
    tw = tsim.simulate_open_loop(tp, tcfg, tr[0].topo, tr[0].config,
                                 list(tr[0].flows), snapshot_impl="dense")
    np.testing.assert_allclose(tw.fcts, jw.fcts, rtol=FCT_RTOL)
    inc = tsim.simulate_open_loop(tp, tcfg, tr[0].topo, tr[0].config,
                                  list(tr[0].flows))
    # the two programs are two keys of one entry point
    assert tsim.TRACE_COUNTS["open_loop"] - before.get("open_loop", 0) in \
        (0, 2)
    np.testing.assert_allclose(inc.fcts, tw.fcts, rtol=FCT_RTOL)
    jb = jsim.simulate_open_loop_batch(
        jp, jcfg, [(r.topo, r.config, list(r.flows)) for r in jr],
        snapshot_impl="dense")
    tb = tsim.simulate_open_loop_batch(
        tp, tcfg, [(r.topo, r.config, list(r.flows)) for r in tr],
        snapshot_impl="dense")
    for a, b in zip(tb, jb):
        assert np.isfinite(a.fcts).all() and (a.fcts > 0).all()
        np.testing.assert_allclose(a.fcts, b.fcts, rtol=FCT_RTOL)
    with pytest.raises(ValueError, match="snapshot_impl"):
        tsim.make_event_step(tcfg, tsim.stack_static([tsim.make_static(
            tr[0].topo, list(tr[0].flows), tr[0].config, tcfg)[0]], "cpu"),
            tr[0].topo.num_links, "sparse")


def test_dense_program_is_its_own_key(models):
    _, _, tcfg, tp = models
    _, req = _scenario(5, 11)
    args = (tp, tcfg, req.topo, req.config, list(req.flows))
    compiled.clear_compiled()
    for impl in ("incremental", "dense"):
        moved = _delta(tsim.TRACE_COUNTS, lambda: tsim.simulate_open_loop(
            *args, snapshot_impl=impl))
        assert moved == {"open_loop": 1}
        assert _delta(tsim.TRACE_COUNTS, lambda: tsim.simulate_open_loop(
            *args, snapshot_impl=impl)) == {}


def test_warmup_reports_the_cold_call(models):
    jcfg, jp, tcfg, tp = models
    jr, tr = _scenario(3, 10)
    compiled.clear_compiled()
    moved, res = _moved(tsim.TRACE_COUNTS, lambda: tsim.simulate_open_loop(
        tp, tcfg, tr.topo, tr.config, list(tr.flows), warmup=True))
    assert moved == {"open_loop": 1}
    assert res.compile_wall > 0 and res.wallclock > 0
    again = tsim.simulate_open_loop(tp, tcfg, tr.topo, tr.config,
                                    list(tr.flows))
    assert again.compile_wall == 0.0
    assert res.fcts.tobytes() == again.fcts.tobytes()
    want = jsim.simulate_open_loop(jp, jcfg, jr.topo, jr.config,
                                   list(jr.flows), warmup=True)
    assert want.compile_wall > 0
    np.testing.assert_allclose(res.fcts, want.fcts, rtol=FCT_RTOL)



@pytest.mark.parametrize("length,stride,plan", [
    (9, None, [("event", 9)]), (0, None, []),
    (8, 4, [("group", 2)]), (9, 4, [("group", 2), ("tail", 1)]),
    (3, 4, [("tail", 1)]), (7, 1, [("group", 7)])])
def test_program_steps_and_plan(length, stride, plan):
    events, samples = [], []

    def event():
        events.append(len(events))
        return events[-1]
    prog = compiled.Program(
        load=None, event=event, result=None, length=length, stride=stride,
        sample=None if stride is None else samples.append)
    assert prog.plan == plan
    prog.run_eager()
    assert events == list(range(length))
    if stride is not None:
        # each sample follows the event of a stride hit
        assert samples == list(range(0, length, stride))


def test_eager_and_record_are_uncounted_and_equal(models):
    _, _, tcfg, tp = models
    _, req = _scenario(4, 9)
    m4 = get_backend("m4", params=tp, cfg=tcfg, device="cpu")
    fs = get_backend("flowsim_fast", device="cpu")
    probes = ProbeConfig(stride=3, max_samples=5)
    preq = dataclasses.replace(req, probes=probes)
    for backend, counts in ((m4, tsim.TRACE_COUNTS),
                            (fs, tff.TRACE_COUNTS)):
        cached = [backend.run(req), backend.run(preq)]
        with compiled.eager():
            moved, (plain, probed) = _moved(counts, lambda: (
                backend.run(req), backend.run(preq)))
        assert moved == {}
        assert plain.fcts.tobytes() == cached[0].fcts.tobytes()
        assert probed.fcts.tobytes() == cached[1].fcts.tobytes()
        for k in ("t", "ev"):
            assert probed.probes[k].tobytes() == cached[1].probes[k].tobytes()
        for ch, v in probed.probes["channels"].items():
            assert v.tobytes() == cached[1].probes["channels"][ch].tobytes()
    args = tff._to_device([tff._pack(req.topo, list(req.flows))], "cpu")
    probes = normalize_probes(probes, FLOWSIM_CHANNELS)
    moved, (fct, log, bufs) = _moved(
        tff.TRACE_COUNTS, lambda: tff._event_scan_core(
            *args, record=True, probes=probes))
    assert moved == {}
    assert log["fid"].shape == (1, 18)
    want = tff._event_scan_core(*args, probes=probes)
    assert fct.numpy().tobytes() == want[0].numpy().tobytes()
    for k, v in bufs.items():
        assert torch.equal(v, want[1][k]), k


def test_entries_report_and_clear(models):
    _, _, tcfg, tp = models
    _, req = _scenario(6, 8)
    compiled.clear_compiled()
    assert compiled.entries() == []
    get_backend("m4", params=tp, cfg=tcfg, device="cpu").run(req)
    get_backend("flowsim_fast", device="cpu").run_many([req, req])
    got = {e["entry"]: e for e in compiled.entries()}
    assert set(got) == {"open_loop", "event_scan_batched"}
    for e in got.values():
        assert e["device"] == "cpu" and e["calls"] == 1
        assert e["graphs"] == [] and e["pool_bytes"] == 0
        assert e["buffer_bytes"] > 0
    compiled.clear_compiled()
    assert compiled.entries() == []
    assert _delta(tff.TRACE_COUNTS, lambda: get_backend(
        "flowsim_fast", device="cpu").run_many([req, req])) == {
        "event_scan_batched": 1}


@pytest.mark.parametrize("K,width", [(0, 4), (1, 4), (2, 4), (4, 4),
                                     (5, 8), (8, 8), (9, 16)])
def test_list_width(K, width):
    assert tff._list_width(K) == width


def test_padded_lists_give_the_kernels_arithmetic_the_same_rates():
    from test_torch_waterfill_event import emulate
    rng = np.random.default_rng(3)
    req = ScenarioSpec(num_flows=300, seed=1).to_request()
    links, cap, *_ = tff._to_device([tff._pack(req.topo, list(req.flows))],
                                    "cpu")
    a = layout.dense_incidence(links, cap.shape[1])
    lists = layout.incidence_lists(a)
    width = tff._list_width(lists.flow_links.shape[2])
    padded = tff._pad_lists(lists, 2 * width)
    assert padded.flow_links.shape[2] == 2 * width
    assert padded.nnz == a.shape[1] * 2 * width >= lists.nnz
    for _ in range(4):
        active = torch.from_numpy(rng.random((1, a.shape[1])) < 0.6)
        want = emulate(lists, cap.numpy(), active.numpy())
        got = emulate(padded, cap.numpy(), active.numpy())
        for x, y in zip(got, want):
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
