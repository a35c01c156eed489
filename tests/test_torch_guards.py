"""`repro_torch.runtime.guards.no_retrace` and the compile counts that
read it, against the JAX package's, on the CPU.

- over the same blocks on explicit counter families, the port's
  `no_retrace` raises `RetraceError` with JAX's message, field for field,
  and moves the registry's `guards.no_retrace.blocks`, `.compiles` and
  `.violations` as JAX's does;
- on the default families (the two event loops' `TRACE_COUNTS`), a new
  shape inside `no_retrace(allowed=0)` raises naming
  `core.simulate.open_loop` or `core.flowsim_fast.event_scan_batched`,
  and a repeat shape passes;
- `trace_total` sums the families, the same three as JAX's;
- `obs.phase` splits `phase.<name>.compiles` and `compile_wall_s` from
  `wall_s` as `jaxprof.phase` does;
- `SweepRunner` runs its misses under `no_retrace(allowed=chunks)`: a
  chunk that compiles twice raises in both packages;
- the scenarios CLI's footer prints the sweep's compile count.
"""
from collections import Counter

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")

from repro.obs import registry as jreg  # noqa: E402
from repro.obs.jaxprof import phase as jphase  # noqa: E402
from repro.runtime import guards as jguards  # noqa: E402
from repro.scenarios import SweepRunner as JaxRunner  # noqa: E402
from repro.scenarios import get_suite as jax_suite  # noqa: E402
from repro.sim import get_backend as jax_backend  # noqa: E402
from repro_torch.core import compiled  # noqa: E402
from repro_torch.core import flowsim_fast as tff  # noqa: E402
from repro_torch.core import simulate as tsim  # noqa: E402
from repro_torch.core.model import M4Config, init_m4  # noqa: E402
from repro_torch.obs import registry as treg  # noqa: E402
from repro_torch.obs.torchprof import phase as tphase  # noqa: E402
from repro_torch.runtime import guards as tguards  # noqa: E402
from repro_torch.scenarios import ScenarioSpec, SweepRunner  # noqa: E402
from repro_torch.scenarios import get_suite  # noqa: E402
from repro_torch.train import loop as ttrain  # noqa: E402
from repro_torch.sim import get_backend  # noqa: E402

GUARD_KEYS = ("guards.no_retrace.blocks", "guards.no_retrace.compiles",
              "guards.no_retrace.violations")
GATE = dict(hidden=16, gnn_dim=16, mlp_hidden=16, gnn_layers=2,
            snap_flows=16, snap_links=32)


def _guard_counts(reg):
    c = reg.snapshot()["counters"]
    return {k: c.get(k, 0) for k in GUARD_KEYS}


def _block(guards, reg, counters, allowed, bumps, label):
    """Run one guarded block that bumps `counters`; returns the error
    message (or None) and the registry's deltas."""
    before = _guard_counts(reg)
    msg = None
    try:
        with guards.no_retrace(allowed=allowed, counters=counters,
                               label=label):
            for fam, key, n in bumps:
                counters[fam][key] += n
    except guards.RetraceError as exc:
        msg = str(exc)
    after = _guard_counts(reg)
    return msg, {k: after[k] - before[k] for k in GUARD_KEYS}


@pytest.mark.parametrize("allowed,bumps,label", [
    (0, [], ""),
    (1, [("core.simulate", "open_loop", 1)], "sweep 'x'"),
    (0, [("core.simulate", "open_loop", 1)], ""),
    (1, [("core.simulate", "open_loop_batched", 2),
         ("core.flowsim_fast", "event_scan", 1)], "serve lane 'm4'"),
])
def test_no_retrace_matches_jax(allowed, bumps, label):
    runs = []
    for guards, reg in ((jguards, jreg.get_registry()),
                        (tguards, treg.get_registry())):
        counters = {"core.simulate": Counter(open_loop=3),
                    "core.flowsim_fast": Counter()}
        runs.append(_block(guards, reg, counters, allowed, bumps, label))
    assert runs[0] == runs[1]
    msg, delta = runs[1]
    new = sum(n for *_, n in bumps)
    assert delta["guards.no_retrace.blocks"] == 1
    assert delta["guards.no_retrace.compiles"] == new
    assert delta["guards.no_retrace.violations"] == (new > allowed)
    assert (msg is None) == (new <= allowed)
    if msg is not None:
        assert msg.startswith(f"{new} compilation(s)")
        assert "core.simulate.open_loop" in msg
        assert (f" in {label}" in msg) == bool(label)
    assert issubclass(tguards.RetraceError, AssertionError)


def test_trace_total_sums_the_families():
    fams = {"a": Counter(x=2, y=1), "b": Counter(z=4)}
    assert tguards.trace_total(fams) == jguards.trace_total(fams) == 7
    assert set(tguards._default_counters()) == \
        set(jguards._default_counters()) == \
        {"core.simulate", "core.flowsim_fast", "train.loop"}
    assert tguards.trace_total() == sum(tsim.TRACE_COUNTS.values()) \
        + sum(tff.TRACE_COUNTS.values()) + sum(ttrain.TRACE_COUNTS.values())


@pytest.mark.parametrize("name", ["m4", "flowsim_fast"])
def test_default_counters_guard_the_event_loops(name):
    cfg = M4Config(**GATE)
    backend = get_backend("m4", params=init_m4(0, cfg), cfg=cfg,
                          device="cpu") if name == "m4" else \
        get_backend("flowsim_fast", device="cpu")
    reqs = [ScenarioSpec(topo="ft-4x2x2", num_flows=n, seed=1,
                         max_load=0.4).to_request() for n in (7, 9)]
    compiled.clear_compiled()
    with tguards.no_retrace(allowed=1):
        backend.run_many(reqs[:1])
    with tguards.no_retrace(allowed=0):
        backend.run_many(reqs[:1])
    key = "core.simulate.open_loop_batched" if name == "m4" else \
        "core.flowsim_fast.event_scan_batched"
    with pytest.raises(tguards.RetraceError, match=f"{key}: \\+1"):
        with tguards.no_retrace(allowed=0, label="a new shape"):
            backend.run_many(reqs[1:])


def test_phase_counts_compiles_as_jaxprof():
    from repro.scenarios import ScenarioSpec as JaxSpec
    fs, jfs = get_backend("flowsim_fast", device="cpu"), \
        jax_backend("flowsim_fast")
    kw = dict(topo="ft-4x2x2", num_flows=6, seed=2, max_load=0.4)
    req, jreq = ScenarioSpec(**kw).to_request(), JaxSpec(**kw).to_request()
    compiled.clear_compiled()
    jax.clear_caches()
    snaps = {}
    for run in ("cold", "warm"):
        t, j = treg.MetricsRegistry("p"), jreg.MetricsRegistry("p")
        with tphase("x", registry=t) as st:
            fs.run(req)
        with jphase("x", registry=j) as jst:
            jfs.run(jreq)
        assert st.compiles == jst.compiles == (run == "cold")
        ts, js = t.snapshot(), j.snapshot()
        assert ts["counters"] == js["counters"]
        assert set(ts["histograms"]) == set(js["histograms"])
        snaps[run] = ts
    assert snaps["cold"]["counters"]["phase.x.compiles"] == 1
    assert set(snaps["cold"]["histograms"]) == {"phase.x.compile_wall_s"}
    assert set(snaps["warm"]["histograms"]) == {"phase.x.wall_s"}


def test_sweep_runner_budget_raises_as_jax(tmp_path):
    """A backend whose chunks compile twice breaks the sweep's budget of
    one program per chunk, in both packages."""
    def twice(backend):
        def run_chunked(requests, chunk_size=None):
            out = backend.run_many(requests)
            backend.run_many(requests[:1])     # a second shape, same chunk
            return out
        backend.run_chunked = run_chunked
        return backend

    compiled.clear_compiled()
    jax.clear_caches()
    for runner, backend, suite, guards in (
            (JaxRunner, jax_backend("flowsim_fast"), jax_suite, jguards),
            (SweepRunner, get_backend("flowsim_fast", device="cpu"),
             get_suite, tguards)):
        specs = suite("smoke16", num_flows=6).limit(2)
        r = runner(twice(backend), chunk_size=None)
        with pytest.raises(guards.RetraceError,
                           match="at most 1 allowed .*event_scan"):
            r.run(specs)


def test_scenarios_cli_prints_the_compile_count(capsys):
    from repro_torch.scenarios.__main__ import main
    compiled.clear_compiled()
    assert main(["smoke16", "--device", "cpu", "--num-flows", "6",
                 "--limit", "3", "--chunk", "0"]) == 0
    assert "-- compiles this run: 1" in capsys.readouterr().out
    assert main(["smoke16", "--device", "cpu", "--num-flows", "6",
                 "--limit", "3", "--chunk", "0"]) == 0
    assert "-- compiles this run: 0" in capsys.readouterr().out
