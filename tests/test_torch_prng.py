"""The port's numpy twin of JAX's bucket-order draw (`train/prng.py`)
against jax 0.9.0 on the CPU, bitwise:

- `threefry2x32`, `fold_in`, `split` and the 32-bit bit draw for several
  keys and data;
- `permutation(key, n)` for n in {0, 1, 2, 7, 100, 1625, 1626, 5000}:
  past n = 1625 `jax.random.permutation` sorts in two rounds;

and `fit(shuffle=True)`, which takes its bucket order from the twin: on
a corpus of two buckets whose first epoch JAX walks in reverse, its
history equals JAX `fit`'s at 1e-4 (the tolerance of the `shuffle=False`
parity test), while the unshuffled walk does not.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")

from repro_torch.train import prng  # noqa: E402

KEYS = [0, 1, 7, 123456, 2 ** 32 - 1]
NS = [0, 1, 2, 7, 100, 1625, 1626, 5000]


def _key(seed):
    return np.array([0, seed], np.uint32)


@pytest.mark.parametrize("seed", KEYS)
def test_fold_in_split_and_bits_equal_jax(seed):
    jk = jax.random.PRNGKey(seed)
    assert np.array_equal(np.asarray(jk), _key(seed))
    for data in (0, 1, 5, 1000, 2 ** 31 + 3, 2 ** 32 - 1):
        assert np.array_equal(np.asarray(jax.random.fold_in(jk, data)),
                              prng.fold_in(_key(seed), data)), data
    assert np.array_equal(np.asarray(jax.random.split(jk)),
                          prng.split(_key(seed)))
    assert np.array_equal(np.asarray(jax.random.split(jk, 5)),
                          prng.split(_key(seed), 5))
    assert np.array_equal(
        np.asarray(jax.random.bits(jk, (33,), np.uint32)),
        prng.random_bits(_key(seed), 33))
    with pytest.raises(ValueError):
        prng.fold_in(_key(seed), 2 ** 32)


@pytest.mark.parametrize("n", NS)
def test_permutation_equals_jax(n):
    for seed in KEYS:
        for ep in (0, 3):
            jk = jax.random.fold_in(jax.random.PRNGKey(seed), ep)
            want = np.asarray(jax.random.permutation(jk, n))
            got = prng.permutation(prng.fold_in(_key(seed), ep), n)
            assert np.array_equal(got, want), (seed, ep)
            assert sorted(got.tolist()) == list(range(n))


def test_two_sort_rounds_start_past_1625():
    rounds = [int(np.ceil(3 * np.log(max(1, n))
                          / np.log(np.iinfo(np.uint32).max))) for n in NS]
    assert rounds == [0, 0, 1, 1, 1, 1, 2, 2]


# ------------------------------------------------ fit(shuffle=True) vs JAX
from repro.core.events import EventBatch as JaxEventBatch  # noqa: E402
from repro.core.model import M4Config as JaxM4Config  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import fit as jax_fit  # noqa: E402
from repro.train import init_state as jax_init_state  # noqa: E402
from repro_torch.core.model import M4Config  # noqa: E402
from repro_torch.scenarios import random_spec  # noqa: E402
from repro_torch.train import (TrainConfig, TrainState,  # noqa: E402
                               build_dataset, fit, make_buckets)
from repro_torch.weights import params_from_jax  # noqa: E402

TINY = dict(hidden=16, gnn_dim=12, mlp_hidden=8, gnn_layers=2,
            snap_flows=8, snap_links=24)
SEED = 1      # fold_in([0, 1], 0) walks two buckets as [1, 0]


def quiet(*_):
    pass


def _state_from_jax(seed) -> TrainState:
    t = jax.device_get(jax_init_state(JaxM4Config(**TINY), seed).tree())
    return TrainState(
        params=params_from_jax(t["params"], "cpu"),
        opt={"m": params_from_jax(t["opt"]["m"], "cpu"),
             "v": params_from_jax(t["opt"]["v"], "cpu"),
             "step": torch.from_numpy(np.array(t["opt"]["step"]))},
        rng=np.asarray(t["rng"]))


def test_fit_shuffled_history_matches_jax(tmp_path):
    specs = [random_spec(s, num_flows=n)
             for s, n in ((0, 12), (1, 14), (2, 16), (3, 20))]
    batches, _ = build_dataset(specs, M4Config(**TINY), str(tmp_path),
                               max_events=32)
    assert len(make_buckets(batches, 2)) == 2
    assert prng.permutation(prng.fold_in(_key(SEED), 0), 2).tolist() == \
        [1, 0]
    tc = dict(epochs=2, bucket_size=2, seed=SEED, shuffle=True)
    jb = [JaxEventBatch.from_arrays(b.to_arrays()) for b in batches]
    _, jhist = jax_fit(jb, JaxM4Config(**TINY), JaxTrainConfig(**tc),
                       state=jax_init_state(JaxM4Config(**TINY), SEED),
                       log=quiet)
    state, hist = fit(
        batches, M4Config(**TINY), TrainConfig(**tc),
        state=_state_from_jax(SEED), device="cpu", log=quiet)
    assert state.step == 8
    for h, j in zip(hist, jhist):
        for k in ("loss", "sldn", "size", "queue", "lr", "grad_norm"):
            np.testing.assert_allclose(h[k], j[k], rtol=1e-4,
                                       err_msg=f"epoch {h['epoch']} {k}")
    # the walk matters: in bucket order the first epoch is another run
    _, plain = fit(batches, M4Config(**TINY),
                   TrainConfig(**dict(tc, shuffle=False)),
                   state=_state_from_jax(SEED), device="cpu", log=quiet)
    assert not np.allclose([plain[0][k] for k in ("loss", "grad_norm")],
                           [jhist[0][k] for k in ("loss", "grad_norm")],
                           rtol=1e-4)
