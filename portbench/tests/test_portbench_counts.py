"""The benchmark's yardstick against the published bounds of the port's
kernels (H100, float32 peak 67 TFLOP/s, 3.35 TB/s) and a count by hand
of m4's operations at its published widths."""
import json
from pathlib import Path

import pytest

from portbench.harness import counts

MODEL = json.loads((Path(__file__).resolve().parents[1] / "configs"
                    / "ft8-table2.json").read_text())["model"]


def test_gru_bound_at_one_scenario_is_the_published_7_71_us():
    flops, nbytes = counts.gru_work(MODEL, 1)
    assert flops == 516_403_200
    assert counts.bound_s(flops, nbytes) * 1e6 == pytest.approx(7.71,
                                                                abs=5e-3)


def test_gnn_bound_at_one_scenario_is_the_published_3_11_us():
    # the published case: 3 rounds, B = 1, 512 edges of which 70% live
    flops, nbytes = counts.gnn_work(MODEL, 1, live_edges=358)
    assert flops == 3 * (2 * 192 * 2 * 300 * 300 + 4 * 358 * 300)
    assert counts.bound_s(flops, nbytes) * 1e6 == pytest.approx(3.11,
                                                                abs=5e-3)


def test_bounds_grow_with_the_batch():
    one = counts.bound_s(*counts.gru_work(MODEL, 1))
    eight = counts.bound_s(*counts.gru_work(MODEL, 8))
    assert eight == pytest.approx(8 * one, rel=1e-12)   # bound by operations


def test_waterfill_event_bound_on_a_small_state():
    # B = 2 scenarios of 10 flows on 8 links, lists of 4 links a flow;
    # 3 and 0 rounds, 20 and 12 incidence entries
    flops, nbytes = counts.waterfill_event_work(2, 10, 8, 4, [3, 0],
                                                [20, 12])
    assert nbytes == 4 * 2 * 10 * 4 + 4 * 2 * 8 + 2 * 10 + 4 * 2 * 10 \
        + 4 * 2 + 2
    assert flops == 3 * (2 * 20 + 3 * 8 + 2 * 10)
    assert counts.bound_s(flops, nbytes) == nbytes / 3.35e12
    # the fabric's state of the published table: bytes-bound, 0.0345 us
    # at one scenario of 2000 flows on 18432 links with 4 links a flow
    _, fab = counts.waterfill_event_work(1, 2000, 18432, 4, [1], [0])
    assert fab / 3.35e12 * 1e6 == pytest.approx(0.0345, abs=5e-4)


def test_m4_step_flops_by_hand():
    """One event of one scenario at M4Config's widths (H 400, G 300, M
    200, C 9, SF 64, SL 128, 3 rounds), every multiply and add once."""
    gru = (2 * 64 * (13 + 400) * 1200 + 2 * 128 * (11 + 400) * 1200
           + 2 * 64 * (309 + 400) * 1200 + 2 * 128 * (309 + 400) * 1200)
    proj = 2 * (64 + 128) * 400 * 300
    rounds = 3 * (2 * (64 + 128) * 2 * 300 * 300 + 4 * 100 * 300)
    sldn = 64 * 2 * (410 * 200 + 200 * 200 + 200 * 1)
    init = 0.5 * 2 * (12 * 200 + 200 * 400)
    want = gru + proj + rounds + sldn + init
    got = counts.m4_step_flops(MODEL, 1, live_edges=100, arrivals=0.5)
    assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx(0.785e9, rel=2e-3)
