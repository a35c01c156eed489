"""`correct` comes out false when the timed path is broken underneath:
the rest of a run (set-up, window, reference, comparison) driven on the
CPU's plain paths at a small size, with each fault a cell can have
planted in the port. The exchange between chips is not among them: both
cells run on one chip. A sound run comes out correct."""
import dataclasses

import numpy as np
import pytest

from portbench.harness import runner
from portbench.tests.conftest import small_cell

M4 = "ft8-table2.m4-b8"
FS = "meta-fabric.flowsim-b8"


def _run(name):
    cell = small_cell(name, flows=40, batch=4)
    result, checks = runner.execute(cell, 2 ** 31 + 3, 0.0, False, 0.0,
                                    log=lambda s: None, device="cpu")
    return result, checks


def _batch_entry(name):
    """(module, attribute) of the batch entry the lane's `run_many`
    calls."""
    if name == M4:
        from repro_torch.core import simulate
        return simulate, "simulate_open_loop_batch"
    from repro_torch.core import flowsim_fast
    return flowsim_fast, "run_flowsim_fast_batch"


@pytest.mark.parametrize("name", [M4, FS])
def test_sound_run_is_correct(name):
    result, checks = _run(name)
    assert result["correct"], checks
    assert result["failed"] == 0


@pytest.mark.parametrize("name", [M4, FS])
def test_state_left_unchanged_is_caught(name, monkeypatch):
    if name == M4:
        from repro_torch.core import simulate

        def body(params, step, state, ptr, order, times, legacy=False):
            t = times[:, 0]
            return state, ptr, t, None, None, None
        monkeypatch.setattr(simulate, "_open_loop_body", body)
    else:
        from repro_torch.kernels import dispatch

        def still(incidence, cap, active, *, max_rounds):
            zero = torch_zeros_like(active)
            return zero, zero.sum(-1).int(), zero.sum(-1) > 0
        monkeypatch.setattr(dispatch, "waterfill_event", still)
    result, checks = _run(name)
    assert not result["correct"], checks


def torch_zeros_like(active):
    import torch
    return torch.zeros(active.shape, dtype=torch.float32)


@pytest.mark.parametrize("name", [M4, FS])
def test_half_the_batch_left_out_is_caught(name, monkeypatch):
    mod, attr = _batch_entry(name)
    real = getattr(mod, attr)

    def half(*args, **kw):
        args = list(args)
        i = 2 if name == M4 else 0          # the scenarios' argument
        scenarios = list(args[i])
        args[i] = scenarios[:len(scenarios) // 2]
        kept = real(*args, **kw)
        return [kept[j % len(kept)] for j in range(len(scenarios))]
    monkeypatch.setattr(mod, attr, half)
    result, checks = _run(name)
    assert not result["correct"], checks


@pytest.mark.parametrize("name", [M4, FS])
def test_one_answer_altered_is_caught(name, monkeypatch):
    mod, attr = _batch_entry(name)
    real = getattr(mod, attr)

    def altered(*args, **kw):
        out = real(*args, **kw)
        last = out[-1]
        out[-1] = dataclasses.replace(
            last, fcts=np.asarray(last.fcts) * (1 + 1e-4))
        return out
    monkeypatch.setattr(mod, attr, altered)
    result, checks = _run(name)
    assert not result["correct"], checks
