"""The port's one-call training pipeline and its CLIs, against the JAX
package's, on the CPU:

- `train_suite` at test width on a 4-spec suite in two buckets (so the
  shuffled walk matters) matches JAX `train_suite`'s history at 1e-4 from
  the same initial weights, with the same dataset key; its evaluation
  gives JAX's flowSim error exactly and m4's at 1e-4; the report has
  JAX's keys (its `obs` snapshot with the training and sweep counters,
  and `train.compiles`, equal to JAX's per run and per epoch); and the
  stores are shared:
  JAX's pipeline, pointed at the port's directories, finds every shard
  and every ground-truth result as a hit;
- `build_dataset(workers > 1)`, which raised while the port had no
  fleet, builds the inline shards where spawn workers can't start (its
  fleet path is in tests/test_torch_fleet_spawn.py);
- `python -m repro_torch.train --device cpu`: a re-run resumes to the
  same weights hash; `--data-key` prints JAX's; the default device raises
  without a card;
- `python -m repro_torch.scenarios`: `--backend m4` restores a JAX-written
  (zstd) checkpoint, and without one fails saying how to make one.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")

from repro.core.model import M4Config as JaxM4Config  # noqa: E402
from repro.runtime import checkpoint as jck  # noqa: E402
from repro.scenarios import get_suite as jax_suite  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import init_state as jax_init_state  # noqa: E402
from repro.train import train_suite as jax_train_suite  # noqa: E402
from repro.train.__main__ import main as jax_train_main  # noqa: E402
from repro_torch.core.model import M4Config  # noqa: E402
from repro_torch.scenarios import get_suite  # noqa: E402
from repro_torch.scenarios.__main__ import main as scenarios_main  # noqa: E402
from repro_torch.train import (TrainConfig, TrainState,  # noqa: E402
                               build_dataset, train_suite)
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train.__main__ import main as train_main  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

TINY = dict(hidden=16, gnn_dim=12, mlp_hidden=8, gnn_layers=2,
            snap_flows=8, snap_links=24)
TINY_FLAGS = ["--hidden", "16", "--gnn-dim", "12", "--mlp-hidden", "8",
              "--snap-flows", "8", "--snap-links", "24"]
# what those flags build: the CLIs take no --gnn-layers (default 3)
FLAGS_CFG = {k: v for k, v in TINY.items() if k != "gnn_layers"}
SEED = 1


def quiet(*_):
    pass


def _state_from_jax(cfg, seed=0, device="cpu") -> TrainState:
    """JAX's `init_state` as the port's, in place of the port's own
    (torch-initialised) weights, so that both pipelines start alike."""
    t = jax.device_get(jax_init_state(JaxM4Config(**TINY), seed).tree())
    return TrainState(
        params=params_from_jax(t["params"], device),
        opt={"m": params_from_jax(t["opt"]["m"], device),
             "v": params_from_jax(t["opt"]["v"], device),
             "step": torch.from_numpy(np.array(t["opt"]["step"]))},
        rng=np.asarray(t["rng"]))


def test_train_suite_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(tloop, "init_state", _state_from_jax)
    kw = dict(n=4, num_flows=14)
    ev = dict(num_flows=16)
    tc = dict(epochs=2, bucket_size=2, seed=SEED, lr=1e-3)
    data, cache = str(tmp_path / "data"), str(tmp_path / "cache")
    state, rep = train_suite(
        get_suite("table2_train_space", **kw), M4Config(**TINY),
        TrainConfig(**tc), data_root=data, max_events=32,
        eval_specs=list(get_suite("table3_empirical", **ev))[:2],
        eval_cache_dir=cache, device="cpu", log=quiet)
    jstate, jrep = jax_train_suite(
        jax_suite("table2_train_space", **kw), JaxM4Config(**TINY),
        JaxTrainConfig(**tc), data_root=data, max_events=32,
        eval_specs=list(jax_suite("table3_empirical", **ev))[:2],
        eval_cache_dir=cache, log=quiet)
    assert set(rep) == set(jrep)
    assert rep["obs"]["schema"] == jrep["obs"]["schema"] == "repro.obs/1"
    # one step call per bucket and epoch, as JAX counts them
    assert rep["obs"]["counters"]["train.steps"] >= 4
    assert 'sweep.cache_misses{backend="packet"}' in rep["obs"]["counters"]
    assert "train.step_wall_s" in rep["obs"]["histograms"]
    assert set(rep["train"]) == set(jrep["train"])
    # one program per bucket shape, counted where JAX counts its compiles
    assert rep["train"]["compiles"] == jrep["train"]["compiles"] > 0
    assert [e["compiles"] for e in rep["train"]["epochs"]] == \
        [e["compiles"] for e in jrep["train"]["epochs"]]
    assert rep["dataset"]["key"] == jrep["dataset"]["key"]
    assert (rep["dataset"]["hits"], rep["dataset"]["misses"]) == (0, 4)
    assert (jrep["dataset"]["hits"], jrep["dataset"]["misses"]) == (4, 0)
    assert rep["suite"] == jrep["suite"] and rep["num_sims"] == 4
    assert rep["train_config"] == jrep["train_config"]
    assert rep["train"]["updates"] == jrep["train"]["updates"] == 8
    for h, j in zip(rep["train"]["epochs"], jrep["train"]["epochs"]):
        for k in ("loss", "sldn", "size", "queue", "lr", "grad_norm"):
            np.testing.assert_allclose(h[k], j[k], rtol=1e-4,
                                       err_msg=f"epoch {h['epoch']} {k}")
    e, je = rep["eval"], jrep["eval"]
    assert e["flowsim_err_mean"] == je["flowsim_err_mean"]
    np.testing.assert_allclose(e["m4_err_mean"], je["m4_err_mean"],
                               rtol=1e-4)
    assert [r["scenario"] for r in e["rows"]] == \
        [r["scenario"] for r in je["rows"]]
    assert rep["weights_hash"] == state.weights_hash()
    json.dumps(rep)          # the report is JSON as it stands


def test_workers_above_one_raise(tmp_path, monkeypatch):
    """workers=2 no longer raises: with no importable __main__ (forced
    here, so nothing is spawned) it builds in-process, the same keys and
    shard bytes as workers=1, and reports no fleet."""
    from repro_torch.train import data
    monkeypatch.setattr(data, "_pool_usable", lambda: False)
    specs = list(get_suite("smoke16", num_flows=6))[:2]
    two, rep2 = build_dataset(specs, M4Config(**TINY), str(tmp_path / "2"),
                              workers=2, max_events=16)
    one, rep1 = build_dataset(specs, M4Config(**TINY), str(tmp_path / "1"),
                              workers=1, max_events=16)
    assert rep2.misses == rep1.misses == 2 and rep2.keys == rep1.keys
    assert rep2.fleet is None and rep1.fleet is None
    for a, b in zip(two, one):
        for k, v in a.to_arrays().items():
            assert v.tobytes() == b.to_arrays()[k].tobytes(), k


def _last_hash(out: str) -> str:
    done = [ln for ln in out.splitlines() if ln.startswith("[train] done")]
    return done[-1].split("weights ")[1].split(",")[0]


def test_train_cli_resumes_and_keys_like_jax(tmp_path, capsys):
    argv = ["--suite", "smoke16", "--limit", "3", "--num-flows", "10",
            "--epochs", "2", "--max-events", "24", "--eval-n", "1",
            "--eval-flows", "12", "--workdir", str(tmp_path), *TINY_FLAGS,
            "--device", "cpu"]
    assert train_main(argv) == 0
    first = capsys.readouterr().out
    assert train_main(argv) == 0
    second = capsys.readouterr().out
    assert "resumed from" in second and "at epoch 2" in second
    assert "3 hit / 0 built" in second
    assert _last_hash(first) == _last_hash(second)
    log = json.load(open(os.path.join(tmp_path, "train_log.json")))
    assert log["weights_hash"].startswith(_last_hash(second))
    key_argv = ["--suite", "smoke16", "--limit", "3", "--num-flows", "10",
                "--max-events", "24", *TINY_FLAGS, "--data-key"]
    assert train_main(key_argv) == 0
    mine = capsys.readouterr().out.strip()
    assert jax_train_main(key_argv) == 0
    assert capsys.readouterr().out.strip() == mine and len(mine) == 64
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(argv[:-2] + ["--workdir", str(tmp_path / "gpu")])


def test_scenarios_cli_restores_a_jax_checkpoint(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    with pytest.raises(SystemExit, match="python -m repro_torch.train"):
        scenarios_main(["smoke16", "--backend", "m4", "--ckpt-dir", ck,
                        "--device", "cpu", *TINY_FLAGS])
    tree = jax_init_state(JaxM4Config(**FLAGS_CFG), seed=2).tree()
    jck.save(ck, 3, tree)                   # zstd: zstandard is installed
    with open(os.path.join(ck, "step_0000000003", "state.msgpack.zst"),
              "rb") as f:
        assert f.read(4) == b"\x28\xb5\x2f\xfd"
    assert scenarios_main(["smoke16", "--backend", "m4", "--ckpt-dir", ck,
                           "--device", "cpu", "--num-flows", "6",
                           "--limit", "3", *TINY_FLAGS]) == 0
    out = capsys.readouterr().out
    assert f"m4 weights {jck.tree_digest(tree['params'])[:12]}" in out
    assert "3 scenarios via m4, 0 cached / 3 simulated" in out
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scenarios_main(["smoke16", "--limit", "1"])
    assert scenarios_main(["--list"]) == 0
    assert "divergence_worst" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="does not take --n"):
        scenarios_main(["smoke16", "--n", "3", "--device", "cpu"])


def test_train_suite_default_device_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_suite(get_suite("smoke16", num_flows=6).limit(1),
                    M4Config(**TINY), TrainConfig(epochs=1),
                    data_root=str(tmp_path))
    assert not os.path.exists(tmp_path / "00")     # nothing built first
    assert dataclasses.asdict(TrainConfig()) == \
        dataclasses.asdict(JaxTrainConfig())
