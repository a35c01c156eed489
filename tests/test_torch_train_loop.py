"""The port's trainer (`repro_torch.train`) on the CPU, against the JAX
package's `repro.train` where both run the same corpus:

- the dataset store over scenario specs: a spec's shard key equals JAX's
  `shard_key` (with the packet seed `request_seed`), and a rebuild is all
  hits with the same bytes;
- bucketing is deterministic and bounded, batch mode makes one update per
  bucket (tests/test_train.py:134, 173);
- `fit` in per-sim mode with `shuffle=False`, 2 epochs on 4 sims from
  JAX's `init_state(seed)` converted: the history's losses at rtol 1e-4
  against JAX `fit` (float32 gradients of 32-event chains in other
  orders, compounded over 8 updates), and its `compiles` equal to JAX's;
- resume reproduces the uninterrupted run bitwise, also past a corrupt
  checkpoint (tests/test_train.py:229, 378);
- the trained weights' hash moves the m4 backend's fingerprint and equals
  JAX's `tree_digest` of the same weights (tests/test_train.py:256);
- `evaluate_m4` over specs reports finite errors against the packet
  ground truth, and with a `cache_dir` a second evaluation serves the
  ground truth and the baseline from the sweep cache; with
  `baseline="flowsim_fast"` (which the port runs on `device`) its errors
  equal JAX's at rtol 1e-4.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")

from repro.core.events import EventBatch as JaxEventBatch  # noqa: E402
from repro.core.model import M4Config as JaxM4Config  # noqa: E402
from repro.runtime.checkpoint import tree_digest as jax_digest  # noqa: E402
from repro.scenarios import random_spec as jax_random_spec  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import evaluate_m4 as jax_evaluate_m4  # noqa: E402
from repro.train import fit as jax_fit  # noqa: E402
from repro.train import init_state as jax_init_state  # noqa: E402
from repro.train import shard_key as jax_shard_key  # noqa: E402
from repro_torch.core.model import M4Config  # noqa: E402
from repro_torch.scenarios import random_spec  # noqa: E402
from repro_torch.sim import get_backend  # noqa: E402
from repro_torch.train import (TrainConfig, TrainState,  # noqa: E402
                               build_dataset, dataset_key, evaluate_m4, fit,
                               init_state, load_state, make_buckets,
                               shard_key)
from repro_torch.weights import (params_from_jax, params_to_numpy,  # noqa: E402
                                 tree_leaves)

TINY = dict(hidden=16, gnn_dim=12, mlp_hidden=8, gnn_layers=2,
            snap_flows=8, snap_links=24)
CFG = M4Config(**TINY)
MAX_EVENTS = 32
HIST_RTOL = 1e-4


def quiet(*_):
    pass


SIMS = ((0, 12), (1, 14), (2, 16), (3, 20))     # (seed, flows)


def _specs():
    return [random_spec(seed, num_flows=n) for seed, n in SIMS]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("store"))
    specs = _specs()
    batches, report = build_dataset(specs, CFG, root, max_events=MAX_EVENTS)
    return specs, batches, report, root


def _state_from_jax(seed=0) -> TrainState:
    t = jax.device_get(jax_init_state(JaxM4Config(**TINY), seed).tree())
    return TrainState(
        params=params_from_jax(t["params"], "cpu"),
        opt={"m": params_from_jax(t["opt"]["m"], "cpu"),
             "v": params_from_jax(t["opt"]["v"], "cpu"),
             "step": torch.from_numpy(np.array(t["opt"]["step"]))},
        rng=np.asarray(t["rng"]))


def _assert_params_bitwise(a, b):
    for (path, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y), path


# ------------------------------------------------------------ dataset store
def test_shard_key_equals_jax(corpus):
    specs, _, _, _ = corpus
    for spec, (seed, n) in zip(specs, SIMS):
        for max_events in (None, MAX_EVENTS):
            for request_seed in (0, seed):
                assert shard_key(spec, CFG, max_events=max_events,
                                 request_seed=request_seed) == \
                    jax_shard_key(jax_random_spec(seed, num_flows=n),
                                  JaxM4Config(**TINY), max_events=max_events,
                                  request_seed=request_seed)
    k0 = shard_key(specs[0], CFG, max_events=MAX_EVENTS)
    assert k0 != shard_key(specs[0], CFG, max_events=MAX_EVENTS + 1)
    assert k0 != shard_key(specs[0], CFG, max_events=MAX_EVENTS,
                           request_seed=9)
    assert k0 == shard_key(specs[0], dataclasses.replace(CFG, gnn_dim=32),
                           max_events=MAX_EVENTS)
    # the key is the request's: a renamed spec shares its shard
    assert k0 == shard_key(dataclasses.replace(specs[0], name="other"), CFG,
                           max_events=MAX_EVENTS)


def test_dataset_rebuild_is_all_hits(corpus):
    specs, batches, report, root = corpus
    assert (report.hits, report.misses) == (0, 4)
    again, report2 = build_dataset(specs, CFG, root, max_events=MAX_EVENTS)
    assert (report2.hits, report2.misses) == (4, 0)
    assert report2.hit_rate == 1.0
    assert report2.corpus_key == dataset_key(specs[::-1], CFG,
                                             max_events=MAX_EVENTS)
    for a, b in zip(batches, again):
        for k, v in a.to_arrays().items():
            assert v.tobytes() == b.to_arrays()[k].tobytes(), k


# ---------------------------------------------------------------- batching
def test_bucketing_is_deterministic_and_bounded(corpus):
    _, batches, _, _ = corpus
    buckets = make_buckets(batches, bucket_size=2)
    assert [b.size for b in buckets] == [2, 2]
    assert max(batches[i].footprint for i in buckets[0].indices) <= \
        min(batches[i].footprint for i in buckets[1].indices)
    again = make_buckets(batches, bucket_size=2)
    assert [b.indices for b in buckets] == [b.indices for b in again]
    assert buckets[1].shape == max(batches[i].footprint
                                   for i in buckets[1].indices)
    with pytest.raises(ValueError):
        make_buckets(batches, bucket_size=0)


def test_batch_mode_single_update_per_bucket(corpus):
    _, batches, _, _ = corpus
    state, hist = fit(batches, CFG, TrainConfig(epochs=2, step_mode="batch"),
                      device="cpu", log=quiet)
    assert state.step == 2          # one averaged update per bucket-epoch
    assert hist[-1]["loss"] < hist[0]["loss"]
    with pytest.raises(ValueError):
        fit(batches, CFG, TrainConfig(step_mode="pmap"), device="cpu",
            log=quiet)


# ------------------------------------------------------- parity with JAX fit
@pytest.fixture(scope="module")
def jax_history(corpus):
    _, batches, _, _ = corpus
    jb = [JaxEventBatch.from_arrays(b.to_arrays()) for b in batches]
    tc = JaxTrainConfig(epochs=2, shuffle=False)
    state, hist = jax_fit(jb, JaxM4Config(**TINY), tc,
                          state=jax_init_state(JaxM4Config(**TINY), 0),
                          log=quiet)
    return state, hist


def test_fit_history_matches_jax(corpus, jax_history):
    _, batches, _, _ = corpus
    jstate, jhist = jax_history
    state, hist = fit(batches, CFG, TrainConfig(epochs=2, shuffle=False),
                      state=_state_from_jax(0), device="cpu", log=quiet)
    assert state.step == jstate.step == 8
    assert len(hist) == len(jhist) == 2
    assert set(hist[0]) == set(jhist[0])
    for h, j in zip(hist, jhist):
        for k in ("loss", "sldn", "size", "queue", "lr", "grad_norm"):
            np.testing.assert_allclose(h[k], j[k], rtol=HIST_RTOL,
                                       err_msg=f"epoch {h['epoch']} {k}")
        # one program per bucket shape in epoch 0, replays after, as JAX
        assert h["compiles"] == j["compiles"]
        assert (h["compile_s"] > 0) == (j["compile_s"] > 0) \
            == (h["compiles"] > 0)
    assert [h["compiles"] for h in hist] == [1, 0]
    assert hist[1]["loss"] < hist[0]["loss"]


# --------------------------------------------------------- state persistence
def test_resume_reproduces_uninterrupted_run_bitwise(corpus, tmp_path):
    _, batches, _, _ = corpus
    full_dir, kill_dir = str(tmp_path / "full"), str(tmp_path / "kill")
    tc = TrainConfig(epochs=4, lr=1e-3, ckpt_dir=full_dir)
    full, full_hist = fit(batches, CFG, tc, device="cpu", log=quiet)
    # a kill after epoch 2 leaves the checkpoints up to step 2
    shutil.copytree(full_dir, kill_dir)
    for d in os.listdir(kill_dir):
        if d.startswith("step_") and int(d[5:]) > 2:
            shutil.rmtree(os.path.join(kill_dir, d))
    res, res_hist = fit(batches, CFG,
                        dataclasses.replace(tc, ckpt_dir=kill_dir),
                        device="cpu", log=quiet)
    _assert_params_bitwise(res.params, full.params)
    assert res.weights_hash() == full.weights_hash()
    assert [h["loss"] for h in res_hist] == [h["loss"] for h in full_hist]
    # a finished run restores and changes nothing
    again, again_hist = fit(batches, CFG, tc, device="cpu", log=quiet)
    assert again.weights_hash() == full.weights_hash()
    assert len(again_hist) == 4
    restored, done = load_state(full_dir, CFG, device="cpu")
    assert done == 4 and restored.step == full.step == 16
    assert load_state(str(tmp_path / "nope"), CFG, device="cpu") == \
        (None, None)


def test_resume_rolls_back_past_corrupt_checkpoint(corpus, tmp_path):
    _, batches, _, _ = corpus
    full_dir, rot_dir = str(tmp_path / "full"), str(tmp_path / "rot")
    tc = TrainConfig(epochs=3, lr=1e-3, ckpt_dir=full_dir, shuffle=True)
    full, _ = fit(batches, CFG, tc, device="cpu", log=quiet)
    shutil.copytree(full_dir, rot_dir)
    blob = os.path.join(rot_dir, "step_0000000003", "state.msgpack.zst")
    raw = bytearray(open(blob, "rb").read())
    raw[10] ^= 0xFF
    open(blob, "wb").write(bytes(raw))
    restored, done = load_state(rot_dir, CFG, device="cpu")
    assert done == 2
    lines = []
    res, res_hist = fit(batches, CFG,
                        dataclasses.replace(tc, ckpt_dir=rot_dir),
                        device="cpu", log=lines.append)
    _assert_params_bitwise(res.params, full.params)
    assert [h["epoch"] for h in res_hist] == [0, 1, 2]
    joined = "\n".join(lines)
    assert "skipping corrupt checkpoint step 3" in joined
    assert "at epoch 2" in joined
    assert "recovered past 1 corrupt checkpoint(s)" in joined


def test_weights_hash_threads_into_backend_fingerprint(corpus, tmp_path):
    _, batches, _, _ = corpus
    ck = str(tmp_path / "ck")
    state, _ = fit(batches, CFG, TrainConfig(epochs=1, ckpt_dir=ck),
                   device="cpu", log=quiet)
    restored, _ = load_state(ck, CFG, device="cpu")
    fresh = init_state(CFG, seed=0, device="cpu")

    def fp(params):
        return get_backend("m4", params=params, cfg=CFG,
                           device="cpu").fingerprint()
    assert fp(state.params) == fp(restored.params)
    assert fp(state.params) != fp(fresh.params)
    assert fp(state.params).startswith("m4_torch-")
    assert state.weights_hash() == restored.weights_hash()
    assert state.weights_hash() != fresh.weights_hash()
    assert state.weights_hash() == jax_digest(params_to_numpy(state.params))


def test_evaluate_m4_against_packet_ground_truth(corpus, tmp_path):
    specs, _, _, _ = corpus
    params = init_state(CFG, seed=0, device="cpu").params
    cache = str(tmp_path / "cache")
    report = evaluate_m4(params, CFG, specs[:2], cache_dir=cache,
                         device="cpu")
    assert report["baseline"] == "flowsim"
    assert [r["scenario"] for r in report["rows"]] == \
        [s.label for s in specs[:2]]
    for k in ("m4_err_mean", "flowsim_err_mean"):
        assert np.isfinite(report[k]) and report[k] >= 0
    # the second evaluation reads the ground truth and baseline back
    again = evaluate_m4(params, CFG, specs[:2], cache_dir=cache,
                        device="cpu")
    assert again == report
    assert len(os.listdir(cache)) == 4       # 2 packet + 2 flowsim entries


def test_evaluate_m4_with_flowsim_fast_baseline_matches_jax(corpus):
    specs, _, _, _ = corpus
    state = _state_from_jax(0)
    report = evaluate_m4(state.params, CFG, specs[:2],
                         baseline="flowsim_fast", device="cpu")
    jparams = jax_init_state(JaxM4Config(**TINY), 0).params
    jspecs = [jax_random_spec(seed, num_flows=n) for seed, n in SIMS[:2]]
    want = jax_evaluate_m4(jparams, JaxM4Config(**TINY), jspecs,
                           baseline="flowsim_fast")
    assert report["baseline"] == want["baseline"] == "flowsim_fast"
    assert [r["scenario"] for r in report["rows"]] == \
        [r["scenario"] for r in want["rows"]]
    for k in ("m4_err", "flowsim_fast_err"):
        np.testing.assert_allclose([r[k] for r in report["rows"]],
                                   [r[k] for r in want["rows"]],
                                   rtol=HIST_RTOL, err_msg=k)
