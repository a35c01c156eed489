"""The port's multi-device paths (`repro_torch.core.sharding`) against the
JAX package's pmap paths, on the CPU.

- `shard_leaves` / `unshard` bitwise as JAX's on trees whose batch is
  not a multiple of the device count (D = 2, 3, 4): the pad repeats the
  last row, and `unshard` drops it;
- one JAX subprocess with two forced host devices (as
  tests/test_scenarios.py:204 and tests/test_train.py:297 run theirs)
  records, into one `.npz`: the sharded `run_many` FCTs of m4 and
  flowsim_fast on 3 Table-2 requests of 12-20 flows (m4 at
  tests/test_scenarios.py's widths, `init_m4(PRNGKey(0))`), a
  `fit(step_mode="batch")` of one epoch over a 3-sim smoke16 bucket
  (its history and final weights), and the `TRACE_COUNTS` deltas;
- the port, with `sharding.local_devices` patched to two CPU entries
  (its counterpart of the forced devices), matches that file: FCTs at
  rtol 1e-5 (m4 plus one float32 ulp of the completion time; the pad
  replica of B = 3 over D = 2 dropped), the loss and the weights at
  1e-4, and each `*_sharded` count equal to JAX's (1); the two shards
  run in turn through one cached program, and a repeat is bitwise;
- the port stays on the batched path where JAX does: a probed batch,
  `snapshot_impl="dense"`, and a batch with fewer scenarios (or sims)
  than devices; a single `run` is never sharded.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")

from repro.core import sharding as jsharding  # noqa: E402
from repro_torch.core import compiled  # noqa: E402
from repro_torch.core import flowsim_fast as tff  # noqa: E402
from repro_torch.core import sharding  # noqa: E402
from repro_torch.core import simulate as tsim  # noqa: E402
from repro_torch.core.model import M4Config, init_m4  # noqa: E402
from repro_torch.core.probes import ProbeConfig  # noqa: E402
from repro_torch.data.traffic import sample_scenario  # noqa: E402
from repro_torch.scenarios import get_suite  # noqa: E402
from repro_torch.sim import SimRequest, get_backend  # noqa: E402
from repro_torch.train import TRACE_COUNTS as TRAIN_COUNTS  # noqa: E402
from repro_torch.train import (TrainConfig, TrainState,  # noqa: E402
                               build_dataset, fit)
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.train.loop import prng_key  # noqa: E402
from repro_torch.weights import tree_leaves, tree_map_with_path  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(hidden=16, gnn_dim=12, mlp_hidden=8, gnn_layers=2,
            snap_flows=8, snap_links=24)
FCT_RTOL = 1e-5
TRAIN_RTOL = 1e-4
CPU = torch.device("cpu")

JAX_SCRIPT = """
import sys, tempfile
import numpy as np, jax
assert jax.local_device_count() == 2, jax.devices()
from repro.core.flowsim_fast import TRACE_COUNTS as FAST
from repro.core.simulate import TRACE_COUNTS as M4
from repro.core.model import M4Config, init_m4
from repro.data.traffic import sample_scenario
from repro.scenarios import get_suite
from repro.sim import SimRequest, get_backend
from repro.train import TRACE_COUNTS as TRAIN, TrainConfig, build_dataset, fit
reqs = [SimRequest.from_scenario(sample_scenario(s, num_flows=12 + 4 * s))
        for s in range(3)]
params = init_m4(jax.random.PRNGKey(0), M4Config(**TINY))
out = {f"init_{i}": np.asarray(leaf)
       for i, leaf in enumerate(jax.tree_util.tree_leaves(params))}
for name, b in (("fs", get_backend("flowsim_fast")),
                ("m4", get_backend("m4", params=params,
                                   cfg=M4Config(**TINY)))):
    for i, res in enumerate(b.run_many(reqs)):
        out[f"{name}_fcts_{i}"] = np.asarray(res.fcts)
suite = get_suite("smoke16", num_flows=12).limit(3)
batches, _ = build_dataset(suite, M4Config(**TINY), tempfile.mkdtemp(),
                           max_events=32)
state, hist = fit(batches, M4Config(**TINY),
                  TrainConfig(epochs=1, step_mode="batch", shuffle=False),
                  log=lambda *a: None)
out["loss"] = np.array([h["loss"] for h in hist])
out["compiles"] = np.array([h["compiles"] for h in hist])
for i, leaf in enumerate(jax.tree_util.tree_leaves(state.params)):
    out[f"param_{i}"] = np.asarray(leaf)
for fam, counts in (("m4", M4), ("fs", FAST), ("train", TRAIN)):
    for k, v in counts.items():
        out[f"count_{fam}_{k}"] = np.array(v)
np.savez(sys.argv[1], **out)
"""


def two_devices(device):
    """`sharding.local_devices` of two forced devices: both the CPU."""
    return [CPU, CPU]


@pytest.fixture(scope="module", autouse=True)
def jax_process(tmp_path_factory):
    """The JAX package's sharded paths on two forced host devices, started
    when the module starts so that it runs beside the port-only tests
    above the JAX comparisons; (process, its .npz path)."""
    path = str(tmp_path_factory.mktemp("jax_sharded") / "out.npz")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    code = f"TINY = {TINY!r}\n" + JAX_SCRIPT
    proc = subprocess.Popen([sys.executable, "-c", code, path], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    yield proc, path
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_sharded(jax_process):
    proc, path = jax_process
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out
    return dict(np.load(path))


def _requests(flows=(12, 16, 20)):
    return [SimRequest.from_scenario(sample_scenario(s, num_flows=n))
            for s, n in enumerate(flows)]


@pytest.fixture(scope="module")
def m4_params():
    return init_m4(0, M4Config(**TINY))


def _jax_init(jax_sharded):
    """JAX's `init_m4(PRNGKey(0))` (the subprocess's leaves, in flattening
    order) as the port's tree."""
    index = {path: i for i, (path, _) in
             enumerate(tree_leaves(init_m4(0, M4Config(**TINY))))}
    return tree_map_with_path(
        lambda path, _: torch.from_numpy(jax_sharded[f"init_{index[path]}"]),
        init_m4(0, M4Config(**TINY)))


# ------------------------------------------------------------ the helpers
@pytest.mark.parametrize("D", [2, 3, 4])
def test_shard_leaves_and_unshard_bitwise_as_jax(D):
    rng = np.random.default_rng(D)
    B = 2 * D + 1                                   # never a multiple of D
    tree = {"a": rng.normal(size=(B, 3)).astype(np.float32),
            "b": rng.integers(0, 9, (B, 2, 2)).astype(np.int64)}
    want = jax.device_get(jsharding.shard_leaves(
        {k: jax.numpy.asarray(v) for k, v in tree.items()}, D))
    got = sharding.shard_leaves({k: torch.from_numpy(v)
                                 for k, v in tree.items()}, D)
    for k in tree:
        assert got[k].shape == want[k].shape
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
        flat = got[k].reshape((-1,) + got[k].shape[2:])
        assert (flat[B:] == flat[B - 1]).all()           # the last row
        back = sharding.unshard(got[k], B)
        assert np.array_equal(back.numpy(), tree[k])
        assert np.array_equal(np.asarray(jsharding.unshard(want[k], B)),
                              back.numpy())


def test_local_devices():
    assert sharding.local_devices("cpu") == [CPU]
    # a card's list starts at cuda:0 and counts every visible card
    with mock.patch.object(torch.cuda, "device_count", return_value=3):
        assert sharding.local_devices("cuda:1") == [
            torch.device("cuda", i) for i in range(3)]


def _assert_fcts(got, want, arrivals, *, ulp_slack):
    """rtol FCT_RTOL, and for m4 (whose clock is float32) one float32 ulp
    of each flow's completion time beside it."""
    slack = np.spacing(np.float32(arrivals + want)).astype(np.float64) \
        if ulp_slack else 0.0
    assert (np.abs(got - want) <= FCT_RTOL * np.abs(want) + slack).all(), \
        np.abs(got - want).max()


def _deltas(before):
    return {k: v - before.get(k, 0)
            for k, v in {**tsim.TRACE_COUNTS, **tff.TRACE_COUNTS}.items()
            if v != before.get(k, 0)}


def test_unsharded_cases_stay_batched(m4_params):
    """A probed batch, the dense program and B < D take the batched path,
    and a single `run` its own, as in JAX (small requests: only the path
    taken is checked)."""
    reqs = _requests((6, 6, 6))
    m4 = get_backend("m4", params=m4_params, cfg=M4Config(**TINY),
                     device="cpu")
    fs = get_backend("flowsim_fast", device="cpu")
    probes = ProbeConfig(stride=4, max_samples=8)
    probed = [dataclasses.replace(r, probes=probes) for r in reqs]
    three = [CPU, CPU, CPU, CPU]
    with mock.patch.object(sharding, "local_devices", two_devices):
        for call in (lambda: m4.run_many(probed), lambda: fs.run_many(probed),
                     lambda: tsim.simulate_open_loop_batch(
                         m4_params, M4Config(**TINY),
                         [(r.topo, r.config, list(r.flows))
                          for r in reqs], snapshot_impl="dense"),
                     lambda: m4.run(reqs[0]), lambda: fs.run(reqs[0])):
            before = {**tsim.TRACE_COUNTS, **tff.TRACE_COUNTS}
            call()
            assert not any(k.endswith("_sharded") for k in _deltas(before))
    with mock.patch.object(sharding, "local_devices", lambda d: three):
        before = {**tsim.TRACE_COUNTS, **tff.TRACE_COUNTS}
        m4.run_many(reqs)                                # B = 3 < D = 4
        fs.run_many(reqs)
        assert not any(k.endswith("_sharded") for k in _deltas(before))


# ----------------------------------------------------- the training step
@pytest.fixture(scope="module")
def corpus():
    suite = get_suite("smoke16", num_flows=12).limit(3)
    batches, _ = build_dataset(suite, M4Config(**TINY), tempfile.mkdtemp(),
                               max_events=32)
    return batches


def _state(params) -> TrainState:
    """The `TrainState` of JAX's `init_state(cfg, 0)` for weights
    `params`: zero moments, step 0, the key of seed 0."""
    return TrainState(params=params, opt=adamw_init(params),
                      rng=prng_key(0))


def test_sharded_step_equals_unsharded_and_tail_bucket(corpus, m4_params):
    """A bucket with fewer sims than devices (B = 3 < D = 4) takes the
    single-device step, counted as "train_step"; the psum-weighted
    sharded update (D = 2, a pad lane weighing 0) equals that plain
    batch mean."""
    tc = TrainConfig(epochs=1, step_mode="batch", shuffle=False)
    before = dict(TRAIN_COUNTS)
    with mock.patch.object(sharding, "local_devices", lambda d: [CPU] * 4):
        s_plain, h_plain = fit(corpus, M4Config(**TINY), tc,
                               state=_state(m4_params), device="cpu",
                               log=lambda *a: None)
    assert {k: v - before.get(k, 0) for k, v in TRAIN_COUNTS.items()
            if v != before.get(k, 0)} == {"train_step": 1}
    with mock.patch.object(sharding, "local_devices", two_devices):
        s_shard, h_shard = fit(corpus, M4Config(**TINY), tc,
                               state=_state(m4_params), device="cpu",
                               log=lambda *a: None)
    np.testing.assert_allclose(h_shard[0]["loss"], h_plain[0]["loss"],
                               rtol=1e-6)
    for (path, a), (_, b) in zip(tree_leaves(s_shard.params),
                                 tree_leaves(s_plain.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=path)


# -------------------------------------- against JAX's pmap (the subprocess)
def test_sharded_run_many_matches_jax(jax_sharded):
    reqs = _requests()
    m4 = get_backend("m4", params=_jax_init(jax_sharded),
                     cfg=M4Config(**TINY), device="cpu")
    fs = get_backend("flowsim_fast", device="cpu")
    compiled.clear_compiled()           # cold, as the JAX process starts
    c0 = {k: dict(c) for k, c in (("m4", tsim.TRACE_COUNTS),
                                  ("fs", tff.TRACE_COUNTS))}
    with mock.patch.object(sharding, "local_devices", two_devices):
        got = {"m4": m4.run_many(reqs), "fs": fs.run_many(reqs)}
        again = m4.run_many(reqs)            # the sharded program, cached
    for name, key in (("m4", "open_loop_sharded"),
                      ("fs", "event_scan_sharded")):
        counts = tsim.TRACE_COUNTS if name == "m4" else tff.TRACE_COUNTS
        delta = {k: v - c0[name].get(k, 0) for k, v in counts.items()
                 if v != c0[name].get(k, 0)}
        assert delta == {key: int(jax_sharded[f"count_{name}_{key}"])} \
            == {key: 1}
        for i, (req, res) in enumerate(zip(reqs, got[name])):
            _assert_fcts(np.asarray(res.fcts),
                         jax_sharded[f"{name}_fcts_{i}"],
                         np.array([f.t_arrival for f in req.flows]),
                         ulp_slack=name == "m4")
    # both shards ran through one program in turn: shard 0's FCTs were
    # copied out before shard 1 loaded, and a repeat is bitwise
    for a, b in zip(got["m4"], again):
        assert np.asarray(a.fcts).tobytes() == np.asarray(b.fcts).tobytes()


def test_sharded_batch_step_matches_jax(jax_sharded, corpus):
    tc = TrainConfig(epochs=1, step_mode="batch", shuffle=False)
    before = dict(TRAIN_COUNTS)
    with mock.patch.object(sharding, "local_devices", two_devices):
        state, hist = fit(corpus, M4Config(**TINY), tc,
                          state=_state(_jax_init(jax_sharded)),
                          device="cpu", log=lambda *a: None)
    delta = {k: v - before.get(k, 0) for k, v in TRAIN_COUNTS.items()
             if v != before.get(k, 0)}
    assert delta == {"train_step_sharded": int(
        jax_sharded["count_train_train_step_sharded"])} \
        == {"train_step_sharded": 1}
    assert [h["compiles"] for h in hist] == list(jax_sharded["compiles"])
    np.testing.assert_allclose([h["loss"] for h in hist],
                               jax_sharded["loss"], rtol=TRAIN_RTOL)
    for i, (path, leaf) in enumerate(tree_leaves(state.params)):
        np.testing.assert_allclose(leaf.numpy(), jax_sharded[f"param_{i}"],
                                   rtol=TRAIN_RTOL, atol=TRAIN_RTOL,
                                   err_msg=path)
