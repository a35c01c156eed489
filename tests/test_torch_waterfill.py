"""The port's water-filling row-min and round against the JAX package's.

- `masked_rowmin_ref` equals JAX's row-min bitwise, in both kernel modes
  (`xla`: the jnp reference; `interpret`: the Pallas kernel under the
  interpreter, as tests/test_kernels.py runs it on the CPU): a min is
  exact, so there is no tolerance;
- the plain `waterfill` matches numpy flowSim's at rtol 1e-5, the bar of
  tests/test_kernels.py;
- `waterfill_event_ref` (the plain version of the per-event kernel and
  flowsim_fast's CPU path) matches JAX's `_waterfill_masked` at rtol 1e-6
  (float32 link sums in another order), including a case where the
  32-round cap binds;
- its fixed 32 rounds equal an early-exit loop bitwise, and its round
  count is that loop's: once every flow is frozen a round is a no-op.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import flowsim_fast as jff  # noqa: E402
from repro.core.flowsim import waterfill as waterfill_np  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro_torch.core import flowsim_fast as tff  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.waterfill import ref  # noqa: E402

MODES = ("xla", "interpret")
WF_RTOL = 1e-6
T = torch.from_numpy


def _rowmin_inputs(rng, F, L, B=None):
    lead = () if B is None else (B,)
    a = (rng.random((*lead, F, L)) < 0.4).astype(np.float32)
    a[..., ::7, :] = 0.0                            # some empty rows
    share = rng.uniform(1e8, 1e10, (*lead, L)).astype(np.float32)
    share[..., ::5] = np.float32(tff.BIG)           # links with no live flow
    return a, share


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("F,L", [(7, 5), (128, 200), (129, 64), (2000, 96)])
def test_rowmin_plain_equals_jax_bitwise(F, L, mode):
    a, share = _rowmin_inputs(np.random.default_rng(F * L), F, L)
    want = np.asarray(jdispatch.masked_rowmin(jnp.asarray(a),
                                              jnp.asarray(share), mode=mode))
    got = dispatch.masked_rowmin(T(a), T(share)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[::7] == np.float32(ref.INF)).all()  # empty rows: INF


def test_rowmin_batch_axis_equals_rows():
    a, share = _rowmin_inputs(np.random.default_rng(1), 33, 17, B=3)
    got = ref.masked_rowmin_ref(T(a), T(share))
    assert got.shape == (3, 33)
    for b in range(3):
        want = np.asarray(jdispatch.masked_rowmin(
            jnp.asarray(a[b]), jnp.asarray(share[b]), mode="xla"))
        np.testing.assert_array_equal(got[b].numpy(), want)


@pytest.mark.parametrize("F,L", [(10, 8), (100, 40), (300, 64)])
def test_plain_waterfill_matches_numpy(F, L):
    rng = np.random.default_rng(F)
    cap = rng.uniform(1e9, 10e9, L)
    paths = [rng.choice(L, size=rng.integers(1, 5), replace=False)
             for _ in range(F)]
    a = np.zeros((F, L), np.float32)
    for i, p in enumerate(paths):
        a[i, p] = 1.0
    got = ref.waterfill(T(a), T(cap.astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), waterfill_np(cap, paths),
                               rtol=1e-5)


def _port_masked(a, cap, active):
    rates, _, _ = ref.waterfill_event_ref(T(a)[None], T(cap)[None],
                                          T(active)[None])
    return rates[0].numpy()


def _jax_masked(a, cap, active, mode):
    return np.asarray(jff._waterfill_masked(
        jnp.asarray(a), jnp.asarray(cap), jnp.asarray(active), mode=mode))


def _capped_case():
    """40 flows, each alone on its own link, distinct capacities: every
    round freezes exactly one flow, so 32 rounds leave 8 unfrozen."""
    n = 40
    a = np.eye(n, dtype=np.float32)
    cap = np.linspace(1e9, 10e9, n).astype(np.float32)[::-1].copy()
    return a, cap, np.ones(n, bool)


@pytest.mark.parametrize("mode", MODES)
def test_waterfill_masked_matches_jax_where_the_cap_binds(mode):
    a, cap, active = _capped_case()
    got = _port_masked(a, cap, active)
    want = _jax_masked(a, cap, active, mode)
    np.testing.assert_allclose(got, want, rtol=WF_RTOL)
    # the 8 largest capacities were never reached: rate 0 in both
    assert (got == 0).sum() == 8 and (want == 0).sum() == 8
    np.testing.assert_array_equal(got[:8], 0.0)
    np.testing.assert_array_equal(got[8:], cap[8:])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", range(3))
def test_waterfill_masked_matches_jax_random(seed, mode):
    rng = np.random.default_rng(seed)
    F, L = 60, 24
    a = np.zeros((F, L), np.float32)
    for i in range(F):
        a[i, rng.choice(L, size=rng.integers(1, 5), replace=False)] = 1.0
    a[-3:] = 0.0                                   # linkless flows
    cap = rng.uniform(1e9, 10e9, L).astype(np.float32)
    active = rng.random(F) < 0.7
    got = _port_masked(a, cap, active)
    np.testing.assert_allclose(got, _jax_masked(a, cap, active, mode),
                               rtol=WF_RTOL)
    assert (got[~active] == 0).all()


def test_fixed_rounds_equal_early_exit():
    for seed in range(6):
        rng = np.random.default_rng(100 + seed)
        B, F, L = 2, 50, 16
        a = (rng.random((B, F, L)) < 0.15).astype(np.float32)
        # every flow crosses a link: an active flow with none is never
        # frozen by the reference's round, and then all 32 rounds run
        a[:, np.arange(F), rng.integers(0, L, F)] = 1.0
        cap = rng.uniform(1e9, 10e9, (B, L)).astype(np.float32)
        active = T(rng.random((B, F)) < 0.8)
        a_t, cap_t = T(a), T(cap)
        fixed, fixed_rounds, capped = ref.waterfill_event_ref(
            a_t.double(), cap_t, active)
        rates = torch.zeros(B, F)
        frozen = ~active
        rounds = torch.zeros(B, dtype=torch.int32)
        while not bool(frozen.all()) and int(rounds.max()) < tff.MAX_ROUNDS:
            rounds += ~frozen.all(-1)
            rates, frozen = ref.waterfill_round_ref(a_t, cap_t, rates, frozen)
        assert 0 < int(rounds.max()) < tff.MAX_ROUNDS  # the exit was early
        assert torch.equal(fixed, torch.where(active, rates, 0.0))
        assert torch.equal(fixed_rounds, rounds) and not capped.any()


def test_tie_factor_rounds_away_in_float32():
    """`theta * (1 + 1e-9)` is theta itself in float32, as in JAX."""
    theta = torch.tensor([1e9, 3.3333333e9, 1.0, 7e-3], dtype=torch.float32)
    assert torch.equal(theta * tff.TIE, theta)
    assert (theta * tff.TIE).dtype == torch.float32
