"""The port's fault-tolerance policies (`repro_torch.runtime.resilience`)
against the JAX package's (`repro.runtime.resilience`), on the CPU.
Every comparison is exact: the backoff delays on a grid of attempts,
tokens and knobs; the decisions, deadlines and straggler counts of
`StepDeadline.observe` over seeded sequences; and `classify_error`'s
verdict on a list of exceptions. `torch.cuda.OutOfMemoryError` is a
RuntimeError, so it is poison, as XLA's runtime errors are in JAX."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.runtime import resilience as jres  # noqa: E402
from repro_torch.runtime import resilience as res  # noqa: E402

BACKOFFS = [dict(), dict(base_s=0.05, factor=2.0, cap_s=0.3),
            dict(base_s=0.25, cap_s=10.0, seed=7),
            dict(base_s=1.0, factor=3.0, cap_s=5.0, jitter=0.0, seed=3),
            dict(base_s=0.1, factor=1.5, cap_s=100.0, jitter=1.0, seed=11)]


@pytest.mark.parametrize("knobs", BACKOFFS)
def test_backoff_delays_equal_jax(knobs):
    mine, ref = res.Backoff(**knobs), jres.Backoff(**knobs)
    tokens = ["", "a", "task-0", "f" * 64,
              "9c1f0e1c2b7a4d8e" * 4]
    for token in tokens:
        for attempt in range(0, 12):
            assert mine.delay(attempt, token) == ref.delay(attempt, token)
    # the jitter only shaves: never above the capped exponential
    raw = min(mine.base_s * mine.factor ** 4, mine.cap_s)
    assert 0.0 <= mine.delay(5, "x") <= raw


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k,floor", [(6.0, 0.05), (3.0, 0.5), (1.0, 0.0)])
def test_step_deadline_decisions_equal_jax(seed, k, floor):
    rng = np.random.default_rng(seed)
    # steady chunk times with a few spikes, long enough to trim the
    # 256-entry history
    times = rng.lognormal(-1.0, 0.2, size=300)
    times[rng.integers(0, 300, size=12)] *= rng.uniform(2, 20, size=12)
    mine, ref = res.StepDeadline(k=k, floor_s=floor), \
        jres.StepDeadline(k=k, floor_s=floor)
    assert mine.deadline == ref.deadline == float("inf")
    decisions = []
    for dt in times.tolist():
        got = mine.observe(dt)
        assert got == ref.observe(dt)
        assert mine.deadline == ref.deadline
        decisions.append(got)
    assert mine.stragglers == ref.stragglers == sum(decisions)
    assert mine.history == ref.history and len(mine.history) == 256
    if k == 6.0:
        assert mine.stragglers >= 1        # the spikes are caught


class _Flagged(Exception):
    retryable = True


class _Unflagged(Exception):
    retryable = False


EXCEPTIONS = [OSError("disk"), IOError("io"), FileNotFoundError("f"),
              TimeoutError("t"), ConnectionError("c"),
              ConnectionResetError("r"), InterruptedError("i"),
              MemoryError("m"), ValueError("v"), TypeError("t"),
              KeyError("k"), RuntimeError("r"), NotImplementedError("n"),
              ZeroDivisionError("z"), AssertionError("a"),
              _Flagged("f"), _Unflagged("u"), KeyboardInterrupt(),
              torch.cuda.OutOfMemoryError("CUDA out of memory")]


@pytest.mark.parametrize("exc", EXCEPTIONS,
                         ids=[type(e).__name__ for e in EXCEPTIONS])
def test_classify_error_equals_jax(exc):
    assert res.classify_error(exc) == jres.classify_error(exc)


def test_error_classes_and_cuda_oom_are_jax_s():
    assert res.RETRYABLE_EXC_TYPES == jres.RETRYABLE_EXC_TYPES
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory")
    assert isinstance(oom, RuntimeError)
    assert res.classify_error(oom) is False            # poison
    assert res.classify_error(MemoryError()) is True   # host memory


def test_timed_measures_a_block():
    with res.Timed() as t:
        sum(range(1000))
    assert t.dt >= 0.0
