"""The controls come out as not correct: the plain reference put in the
program's place in the precision below the configuration's (m4: float32
products in TF32, on the card; flowSim: every float32 result rounded to
bfloat16), judged by the cell's own limits, at sizes a test run holds.
`portbench/calibrate.py` reads the same at the cells' own sizes."""
import numpy as np
import pytest

from portbench.harness import check, gen, lanes, weights
from portbench.tests.conftest import small_cell


def _judged(cell, outs, refs):
    return check.judge(check.numbers(outs, refs), cell.limits)


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
                 backend.run_many(lanes.requests(b))])
            for k, b in enumerate(pool)]
    refs = {k: lane.reference(b, w, card)[0] for k, b in enumerate(pool)}
    ctrl = [(k, lane.reference(b, w, card, control=True)[0])
            for k, b in enumerate(pool)]
    assert all(c["ok"] for c in _judged(cell, outs, refs).values())
    assert not all(c["ok"] for c in _judged(cell, ctrl, refs).values())
