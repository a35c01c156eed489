"""The compiled training step (`repro_torch.train.loop.TRACE_COUNTS`,
`core.compiled.StepCache`) against the JAX package's jitted step, on the
CPU, at the training widths of tests/test_torch_train_loop.py (hidden 16,
GNN 12, MLP 8, 2 rounds, SF 8, SL 24; 4 sims of 12-20 flows, 32 events,
two bucket shapes at bucket_size 2), weights from JAX's `init_state`:

- the `TRACE_COUNTS` deltas equal JAX's over each of: a per-sim `fit`
  and a batch `fit` over two bucket shapes, a second `fit` of the same
  corpus, a resumed and a finished `fit`, `train_suite`,
  `make_train_step` over two sim shapes (and again after
  `clear_compiled()`, as after `jax.clear_caches()`), and `train_m4`;
- the history's `compiles` per epoch equals JAX's, with `compile_s > 0`
  exactly where it compiled; `train.compiles` and `train.compile_wall_s`
  enter the registry where JAX's do;
- `no_retrace(allowed=0)` on the default families around a second `fit`
  raises `RetraceError` with JAX's message; `_default_counters()` names
  JAX's three families; `phase("x")` counts a fit's programs as
  `jaxprof.phase` counts its compiles;
- `make_train_step` and `train_m4` losses at `HIST_RTOL` against JAX's,
  and their weights at `HIST_RTOL` of each leaf's largest magnitude;
- `eval_fn` runs after the epochs JAX's runs after;
- a `TrainState` that one `fit` returned is unchanged, bitwise, by a later
  `fit` that starts from it and by `clear_compiled()`; a live step's
  programs appear in `compiled.entries()` and go with the step;
- `python -m repro_torch.train --device cpu` killed by
  `REPRO_TRAIN_ABORT_AFTER_EPOCH=1` right after its epoch-1 checkpoint
  (rc 17) resumes to an uninterrupted run's weights hash and losses
  (tests/test_train.py:335).
"""
import gc
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")

from repro.core.events import EventBatch as JaxEventBatch  # noqa: E402
from repro.core.model import M4Config as JaxM4Config  # noqa: E402
from repro.core.training import _as_jnp  # noqa: E402
from repro.core.training import make_train_step as jax_make_step  # noqa: E402
from repro.core.training import train_m4 as jax_train_m4  # noqa: E402
from repro.obs import registry as jreg  # noqa: E402
from repro.obs.jaxprof import phase as jphase  # noqa: E402
from repro.runtime import guards as jguards  # noqa: E402
from repro.scenarios import get_suite as jax_suite  # noqa: E402
from repro.train import TRACE_COUNTS as JAX_COUNTS  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import fit as jax_fit  # noqa: E402
from repro.train import init_state as jax_init_state  # noqa: E402
from repro.train import train_suite as jax_train_suite  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import compiled  # noqa: E402
from repro_torch.core.model import M4Config  # noqa: E402
from repro_torch.core.training import make_train_step, train_m4  # noqa: E402
from repro_torch.obs.registry import MetricsRegistry  # noqa: E402
from repro_torch.obs.torchprof import phase as tphase  # noqa: E402
from repro_torch.runtime import guards as tguards  # noqa: E402
from repro_torch.scenarios import get_suite, random_spec  # noqa: E402
from repro_torch.train import (TRACE_COUNTS, TrainConfig,  # noqa: E402
                               TrainState, build_dataset, fit, make_buckets,
                               train_suite)
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.weights import (params_from_jax, tree_digest,  # noqa: E402
                                 tree_leaves)

TINY = dict(hidden=16, gnn_dim=12, mlp_hidden=8, gnn_layers=2,
            snap_flows=8, snap_links=24)
CFG = M4Config(**TINY)
JCFG = JaxM4Config(**TINY)
MAX_EVENTS = 32
HIST_RTOL = 1e-4
SIMS = ((0, 12), (1, 14), (2, 16), (3, 20))     # (seed, flows)
HEADS = ("loss", "sldn", "size", "queue", "lr", "grad_norm")


def quiet(*_):
    pass


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(port batches, JAX batches): two bucket shapes at bucket_size 2."""
    root = str(tmp_path_factory.mktemp("store"))
    specs = [random_spec(seed, num_flows=n) for seed, n in SIMS]
    batches, _ = build_dataset(specs, CFG, root, max_events=MAX_EVENTS)
    assert len({b.shape for b in make_buckets(batches, 2)}) == 2
    return batches, [JaxEventBatch.from_arrays(b.to_arrays())
                     for b in batches]


def _jax_tree(seed=0):
    return jax.device_get(jax_init_state(JCFG, seed).tree())


def _state(seed=0) -> TrainState:
    """JAX's `init_state(seed)` as the port's."""
    t = _jax_tree(seed)
    return TrainState(
        params=params_from_jax(t["params"], "cpu"),
        opt={"m": params_from_jax(t["opt"]["m"], "cpu"),
             "v": params_from_jax(t["opt"]["v"], "cpu"),
             "step": torch.from_numpy(np.array(t["opt"]["step"]))},
        rng=np.asarray(t["rng"]))


def _delta(counts, call):
    """(call's result, {key: new programs} it added to `counts`)."""
    before = dict(counts)
    out = call()
    return out, {k: v - before.get(k, 0) for k, v in counts.items()
                 if v != before.get(k, 0)}


def _both(tc_kw, corpus, **kw):
    """The same `fit` in both packages from JAX's initial state: (port
    (state, history), port delta, JAX (state, history), JAX delta)."""
    batches, jbatches = corpus
    port, pd = _delta(TRACE_COUNTS, lambda: fit(
        batches, CFG, TrainConfig(**tc_kw), state=_state(), device="cpu",
        log=quiet, **kw))
    ref, jd = _delta(JAX_COUNTS, lambda: jax_fit(
        jbatches, JCFG, JaxTrainConfig(**tc_kw),
        state=jax_init_state(JCFG, 0), log=quiet, **kw))
    return port, pd, ref, jd


def _assert_history(hist, jhist):
    assert len(hist) == len(jhist)
    for h, j in zip(hist, jhist):
        assert set(h) == set(j)
        for k in HEADS:
            np.testing.assert_allclose(h[k], j[k], rtol=HIST_RTOL,
                                       err_msg=f"epoch {h['epoch']} {k}")
        assert h["compiles"] == j["compiles"]
        assert (h["compile_s"] > 0) == (j["compile_s"] > 0) \
            == (h["compiles"] > 0)


def _assert_weights(params, jparams):
    want = dict(tree_leaves(jax.device_get(jparams)))
    for path, leaf in tree_leaves(params):
        w = np.asarray(want[path])
        np.testing.assert_allclose(leaf.numpy(), w, rtol=HIST_RTOL,
                                   atol=HIST_RTOL * np.abs(w).max(),
                                   err_msg=path)


# ------------------------------------------------------------ fit's counts
@pytest.mark.parametrize("mode", ["per_sim", "batch"])
def test_fit_counts_one_program_per_bucket_shape_as_jax(corpus, mode):
    tc = dict(epochs=2, bucket_size=2, step_mode=mode, lr=1e-3)
    (state, hist), pd, (jstate, jhist), jd = _both(tc, corpus)
    assert pd == jd == {"train_step": 2}
    assert [h["compiles"] for h in hist] == [2, 0]
    _assert_history(hist, jhist)
    assert state.step == jstate.step
    # a second fit of the same corpus builds its own programs again
    (_, hist2), pd2, (_, jhist2), jd2 = _both(tc, corpus)
    assert pd2 == jd2 == {"train_step": 2}
    _assert_history(hist2, jhist2)


def test_resumed_fit_compiles_and_a_finished_one_does_not(corpus, tmp_path):
    batches, jbatches = corpus
    # 1 epoch, then resumed to 2 (its own programs), then finished (none)
    for epochs, want in ((1, 2), (2, 2), (2, 0)):
        kw = dict(epochs=epochs, bucket_size=2, lr=1e-3, schedule="const")
        (state, hist), pd = _delta(TRACE_COUNTS, lambda: fit(
            batches, CFG, TrainConfig(ckpt_dir=str(tmp_path / "port"), **kw),
            state=_state(), device="cpu", log=quiet))
        (jstate, jhist), jd = _delta(JAX_COUNTS, lambda: jax_fit(
            jbatches, JCFG, JaxTrainConfig(ckpt_dir=str(tmp_path / "jax"),
                                           **kw),
            state=jax_init_state(JCFG, 0), log=quiet))
        assert pd == jd == ({"train_step": want} if want else {})
        _assert_history(hist, jhist)
        assert state.step == jstate.step == 4 * epochs
    assert [h["compiles"] for h in hist] == [2, 2]


def test_fit_records_compiles_in_the_registry_as_jax(corpus):
    tc = dict(epochs=2, bucket_size=2, lr=1e-3)
    t0 = obs.get_registry().snapshot()
    j0 = jreg.get_registry().snapshot()
    _both(tc, corpus)
    t1 = obs.get_registry().snapshot()
    j1 = jreg.get_registry().snapshot()

    def moved(a, b, name):
        return b["counters"].get(name, 0) - a["counters"].get(name, 0)

    assert moved(t0, t1, "train.compiles") == \
        moved(j0, j1, "train.compiles") == 2
    for snap, before in ((t1, t0), (j1, j0)):
        hist = snap["histograms"]["train.compile_wall_s"]
        # one observation for the epoch that compiled, none for the other
        assert hist["count"] - before["histograms"].get(
            "train.compile_wall_s", {"count": 0})["count"] == 1
        assert hist["sum"] > 0


# -------------------------------------------------- guards, phase, families
def test_no_retrace_around_a_second_fit_raises_as_jax(corpus):
    batches, jbatches = corpus
    tc = dict(epochs=1, bucket_size=2)
    fit(batches, CFG, TrainConfig(**tc), state=_state(), device="cpu",
        log=quiet)
    jax_fit(jbatches, JCFG, JaxTrainConfig(**tc),
            state=jax_init_state(JCFG, 0), log=quiet)
    with pytest.raises(tguards.RetraceError) as port:
        with tguards.no_retrace(allowed=0, label="refit"):
            fit(batches, CFG, TrainConfig(**tc), state=_state(),
                device="cpu", log=quiet)
    with pytest.raises(jguards.RetraceError) as ref:
        with jguards.no_retrace(allowed=0, label="refit"):
            jax_fit(jbatches, JCFG, JaxTrainConfig(**tc),
                    state=jax_init_state(JCFG, 0), log=quiet)
    assert "train.loop.train_step: +2" in str(port.value)
    assert str(port.value) == str(ref.value)


def test_default_counters_and_phase_count_training_programs(corpus):
    batches, jbatches = corpus
    assert set(tguards._default_counters()) == \
        set(jguards._default_counters())
    tc = dict(epochs=1, bucket_size=2)
    c0 = tguards.trace_total()
    with tphase("x", registry=MetricsRegistry()) as st:
        fit(batches, CFG, TrainConfig(**tc), state=_state(), device="cpu",
            log=quiet)
    with jphase("x", registry=jreg.MetricsRegistry()) as jst:
        jax_fit(jbatches, JCFG, JaxTrainConfig(**tc),
                state=jax_init_state(JCFG, 0), log=quiet)
    assert st.compiles == jst.compiles == 2
    assert tguards.trace_total() - c0 == 2


# -------------------------------------------------------- eval_fn, aliasing
def test_eval_fn_runs_after_the_epochs_jax_runs_it_after(corpus):
    calls, jcalls = [], []

    def probe(log):
        def eval_fn(params):
            log.append(len(log))
            return {"n": len(log)}
        return eval_fn

    batches, jbatches = corpus
    tc = dict(epochs=3, bucket_size=4, lr=1e-3)
    _, hist = fit(batches, CFG, TrainConfig(**tc), state=_state(),
                  device="cpu", log=quiet, eval_fn=probe(calls),
                  eval_every=2)
    _, jhist = jax_fit(jbatches, JCFG, JaxTrainConfig(**tc),
                       state=jax_init_state(JCFG, 0), log=quiet,
                       eval_fn=probe(jcalls), eval_every=2)
    assert [h.get("eval") for h in hist] == [h.get("eval") for h in jhist] \
        == [None, {"n": 1}, {"n": 2}]


def test_a_returned_state_is_the_callers_own(corpus):
    batches, _ = corpus
    tc = TrainConfig(epochs=1, bucket_size=2, lr=1e-3)
    first, _ = fit(batches, CFG, tc, state=_state(), device="cpu",
                   log=quiet)
    digest = tree_digest(first.tree())
    second, _ = fit(batches, CFG, tc, state=first, device="cpu", log=quiet)
    assert second.step == 2 * first.step
    assert tree_digest(first.tree()) == digest
    compiled.clear_compiled()
    assert tree_digest(first.tree()) == digest
    assert tree_digest(second.tree()) != digest


def test_step_programs_live_and_die_with_their_step(corpus):
    batches, _ = corpus
    b = {k: torch.from_numpy(v) for k, v in batches[0].to_arrays().items()}
    st = _state()
    step = make_train_step(CFG, lr=1e-3)

    def legacy():
        return [e for e in compiled.entries()
                if e["entry"] == "train_step_legacy"]

    before = len(legacy())
    step(st.params, st.opt, b)
    step(st.params, st.opt, b)
    (e,) = legacy()[before:]
    assert e["calls"] == 2 and e["device"] == "cpu" and e["graphs"] == []
    assert e["replays_per_call"] == 1 and e["buffer_bytes"] > 0
    del step
    gc.collect()
    assert len(legacy()) == before


# ------------------------------------------------- the legacy direct API
def test_make_train_step_matches_jax(corpus):
    batches, jbatches = corpus
    jstep = jax_make_step(JCFG, lr=1e-3)
    step = make_train_step(CFG, lr=1e-3)
    t = _jax_tree()
    jp, jo = t["params"], t["opt"]
    st = _state()
    tp, to = st.params, st.opt
    counts, jcounts = [], []
    for i in (0, 1, 0, "clear", 0):
        if i == "clear":
            compiled.clear_compiled()
            jax.clear_caches()
            continue
        (tp, to, tot, parts, gn), d = _delta(TRACE_COUNTS, lambda: step(
            tp, to, {k: torch.from_numpy(v)
                     for k, v in batches[i].to_arrays().items()}))
        (jp, jo, jtot, jparts, jgn), jd = _delta(JAX_COUNTS, lambda: jstep(
            jp, jo, _as_jnp(jbatches[i])))
        counts.append(d)
        jcounts.append(jd)
        np.testing.assert_allclose(float(tot), float(jtot), rtol=HIST_RTOL)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=HIST_RTOL)
        for k in ("size", "queue", "sldn"):
            np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                       rtol=HIST_RTOL, err_msg=k)
    one = {"train_step_legacy": 1}
    assert counts == jcounts == [one, one, {}, one]
    assert int(to["step"]) == int(jo["step"]) == 4
    _assert_weights(tp, jp)


def test_train_m4_matches_jax(corpus, monkeypatch):
    # the port's own init draws other numbers: start both from JAX's
    monkeypatch.setattr(tloop, "init_state",
                        lambda cfg, seed=0, device="cpu": _state(seed))
    batches, jbatches = corpus
    (state, hist), d = _delta(TRACE_COUNTS, lambda: train_m4(
        batches, CFG, epochs=2, lr=1e-3, bucket_size=2, log=quiet,
        device="cpu"))
    (jstate, jhist), jd = _delta(JAX_COUNTS, lambda: jax_train_m4(
        jbatches, JCFG, epochs=2, lr=1e-3, bucket_size=2, log=quiet))
    assert d == jd == {"train_step": 2}
    assert state.step == jstate.step == 8
    _assert_history(hist, jhist)
    _assert_weights(state.params, jstate.params)


# ---------------------------------------------------------- train_suite
def test_train_suite_counts_programs_as_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(tloop, "init_state",
                        lambda cfg, seed=0, device="cpu": _state(seed))
    kw = dict(n=4, num_flows=14)
    tc = dict(epochs=2, bucket_size=2, seed=1, lr=1e-3)
    data = str(tmp_path / "data")
    (_, rep), d = _delta(TRACE_COUNTS, lambda: train_suite(
        get_suite("table2_train_space", **kw), CFG, TrainConfig(**tc),
        data_root=data, max_events=MAX_EVENTS, device="cpu", log=quiet))
    (_, jrep), jd = _delta(JAX_COUNTS, lambda: jax_train_suite(
        jax_suite("table2_train_space", **kw), JCFG, JaxTrainConfig(**tc),
        data_root=data, max_events=MAX_EVENTS, log=quiet))
    assert d == jd and sum(d.values()) == rep["train"]["compiles"] \
        == jrep["train"]["compiles"] > 0
    _assert_history(rep["train"]["epochs"], jrep["train"]["epochs"])
    assert rep["obs"]["counters"]["train.compiles"] >= \
        rep["train"]["compiles"]


# ------------------------------------------------------------------- CLI
def test_cli_kill_resume_end_to_end(tmp_path):
    """`python -m repro_torch.train --device cpu`: killed after the epoch-1
    checkpoint (os._exit, nothing cleaned up), the identical command
    resumes and reproduces the uninterrupted run's weights hash and
    losses; the dataset build is all hits on every rerun."""
    work = str(tmp_path / "w")
    args = [sys.executable, "-m", "repro_torch.train", "--suite", "smoke16",
            "--limit", "4", "--num-flows", "12", "--max-events", "32",
            "--epochs", "3", "--hidden", "16", "--gnn-dim", "12",
            "--mlp-hidden", "8", "--snap-flows", "8", "--snap-links", "24",
            "--eval-suite", "none", "--workdir", work, "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    env.pop("REPRO_TRAIN_ABORT_AFTER_EPOCH", None)

    def run(extra_env=None, ckpt=None):
        cmd = args + (["--ckpt-dir", ckpt] if ckpt else [])
        return subprocess.run(cmd, env=dict(env, **(extra_env or {})),
                              capture_output=True, text=True, timeout=300)

    killed = run({"REPRO_TRAIN_ABORT_AFTER_EPOCH": "1"})
    assert killed.returncode == 17, killed.stdout + killed.stderr
    assert not os.path.exists(os.path.join(work, "train_log.json"))
    resumed = run()
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    assert "resumed from" in resumed.stdout
    with open(os.path.join(work, "train_log.json")) as f:
        log = json.load(f)
    assert log["dataset"] == {**log["dataset"], "hits": 4, "misses": 0}
    # epoch 0's program was the killed run's; the resumed run builds its own
    assert [e["compiles"] for e in log["train"]["epochs"]] == [1, 1, 0]
    assert log["train"]["compiles"] == 1
    # uninterrupted reference: same data store, fresh checkpoint dir
    fresh = run(ckpt=str(tmp_path / "ck2"))
    assert fresh.returncode == 0, fresh.stdout + fresh.stderr
    with open(os.path.join(work, "train_log.json")) as f:
        log2 = json.load(f)
    assert log2["weights_hash"] == log["weights_hash"], \
        "resumed run diverged from uninterrupted run"
    assert [e["loss"] for e in log2["train"]["epochs"]] == \
        [e["loss"] for e in log["train"]["epochs"]]
    assert [e["compiles"] for e in log2["train"]["epochs"]] == [1, 0, 0]
    assert log2["train"]["compiles"] == 1
