"""The controls come out as not correct: the plain reference put in the
program's place in the precision below the configuration's (m4: float32
products in TF32, on the card; flowSim: every float32 result rounded to
bfloat16; the LM: every product's inputs rounded to float8, on the card
at the configuration's full widths), judged by the cell's own limits, at
sizes a test run holds. `portbench/calibrate.py` reads the same at the
cells' own sizes."""
import numpy as np
import pytest

from portbench.harness import check, flows, gen, lanes, weights
from portbench.tests.conftest import small_cell


def _judged(cell, outs, refs):
    return check.judge(flows.numbers(outs, refs), cell.limits)


@pytest.mark.parametrize("seed", [4, 2 ** 31 + 9])
def test_flowsim_control_is_not_correct(seed):
    cell = small_cell("meta-fabric.flowsim-b8", flows=200)
    lane = lanes.lane(cell.traffic, cell.config)
    pool = gen.pool(cell.config, cell.traffic, seed)
    refs = {k: lane.reference(b, None, "cpu")[0] for k, b in enumerate(pool)}
    ctrl = [(k, lane.reference(b, None, "cpu", control=True)[0])
            for k, b in enumerate(pool)]
    assert not all(c["ok"] for c in _judged(cell, ctrl, refs).values())
    same = [(k, refs[k]) for k in refs]
    assert all(c["ok"] for c in _judged(cell, same, refs).values())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [4, 2 ** 31 + 9])
def test_m4_control_is_not_correct_and_the_port_is(card, seed):
    cell = small_cell("ft8-table2.m4-b8", flows=400, batch=4)
    cell.config["model"].update(hidden=400, gnn_dim=300, mlp_hidden=200,
                                snap_flows=64, snap_links=128)
    lane = lanes.lane(cell.traffic, cell.config)
    w = weights.make(cell.config["model"], seed, card)
    pool = gen.pool(cell.config, cell.traffic, seed)
    backend = lane.backend(w, card)
    outs = [(k, [np.asarray(r.fcts) for r in
                 backend.run_many(flows.requests(b))])
            for k, b in enumerate(pool)]
    refs = {k: lane.reference(b, w, card)[0] for k, b in enumerate(pool)}
    ctrl = [(k, lane.reference(b, w, card, control=True)[0])
            for k, b in enumerate(pool)]
    assert all(c["ok"] for c in _judged(cell, outs, refs).values())
    assert not all(c["ok"] for c in _judged(cell, ctrl, refs).values())


def _lm_small_batch(card, seed, batch=8):
    """The LM cell at its widths, prompt and steps, `batch` sessions all
    sampled: (cell, lane, weights, the pool batch, its inputs, the
    reference's logits)."""
    import copy

    from portbench.harness import spec
    from portbench.tests.conftest import LM
    cell = copy.deepcopy(spec.find_cell(spec.load_benchmark(), LM, False))
    cell.traffic.update(batch=batch, sample=batch, pool=1)
    lane = lanes.lane(cell.traffic, cell.config)
    w = lane.weights(seed, card)
    batch = lane.pool(seed)[0]
    inputs = lane.inputs(batch, card)
    return cell, lane, w, batch, inputs, {0: lane.reference(batch, w,
                                                             card)[0]}


def _lm_judged(cell, lane, got, refs):
    numbers = lane.numbers([(0, got)], refs)
    print(cell.name, numbers)
    return check.judge(numbers, cell.limits)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [4, 2 ** 31 + 9])
def test_lm_control_is_not_correct_and_the_port_is(card, seed):
    """zamba2-2.7b at its widths, 8 sessions of the cell's prompt and
    steps: the port's logits within the cell's limits, the float8
    control's not."""
    cell, lane, w, batch, inputs, refs = _lm_small_batch(card, seed)
    got = lane.call(lane.backend(w, card), inputs)[0]
    assert all(c["ok"] for c in _lm_judged(cell, lane, got, refs).values())
    ctrl = lane.reference(batch, w, card, control=True)[0]
    assert not all(c["ok"] for c in
                   _lm_judged(cell, lane, ctrl, refs).values())


def _state_unchanged(monkeypatch):
    from repro_torch import models
    real = models.serve_step

    def still(p, cfg, state, batch, **kw):
        old = dict(state)
        return old, real(p, cfg, state, batch, **kw)[1]
    monkeypatch.setattr(models, "serve_step", still)


@pytest.mark.cuda
def test_lm_state_left_unchanged_at_full_widths_is_caught(card,
                                                          monkeypatch):
    """The port's decode step returning its caches and states unchanged,
    at the cell's widths, prompt and steps, fails the cell's comparison.
    Faults of one layer or one slot read under the limits (PERF.md)."""
    cell, lane, w, batch, inputs, refs = _lm_small_batch(card, 2 ** 31 + 5)
    _state_unchanged(monkeypatch)
    got = lane.call(lane.backend(w, card), inputs)[0]
    assert not all(c["ok"] for c in
                   _lm_judged(cell, lane, got, refs).values())
