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


def test_lm_decode_step_by_hand_at_the_smoke_size():
    """One decode step of zamba2-2.7b at `reduce_for_smoke`'s widths (D 64,
    V 256, F 128, 4 heads of 16 over 2 kv heads, di 128, state 16, head
    16, 4 layers, a site every 2, float32), B 2 at position 5, and its
    weights read against the port's own parameter tree."""
    import torch
    from portbench.tests.conftest import smoke_arch
    from repro_torch.models import init_params
    cfg = smoke_arch("zamba2-2.7b")
    m = {k: getattr(cfg, k) for k in (
        "family", "moe", "d_model", "vocab", "d_ff", "num_heads",
        "num_kv_heads", "head_dim", "ssm_expand", "ssm_state",
        "ssm_head_dim", "num_layers", "hybrid_attn_every")}
    m["dtype"] = "float32"
    ssm = (2 * 64 * (256 + 32 + 8) + 2 * 4 * 160 + 5 * 8 * 16 * 16
           + 2 * 128 * 64)
    attn = (2 * 64 * 16 * (4 + 4) + 2 * 4 * 16 * 64 + 4 * 4 * 16 * 6
            + 6 * 64 * 128)
    flops, nbytes = counts.lm_decode_work(m, {"d_conv": 4}, 2, 5)
    assert flops == 2 * (4 * ssm + 2 * attn + 2 * 64 * 256)
    params = 4 * (64 * 296 + 4 * 160 + 160 + 24 + 128 + 64 + 128 * 64) \
        + (64 * 16 * 8 + 4 * 16 * 64 + 3 * 64 * 128 + 128) + 64 \
        + 64 * 256 + 2 * 64
    leaves = sum(x.numel() for x in _leaves(
        init_params(torch.Generator(), cfg, device="meta")))
    assert params == leaves - 256 * 64 + 2 * 64   # B rows of the table
    kv = 2 * 2 * 2 * 2 * 16 * 6                   # sites, B, k and v, t + 1
    states = 2 * 4 * 2 * (8 * 16 * 16 + 3 * 160)  # read and written
    assert nbytes == 4 * (params + kv + states + 2 * 256) + 8 * 2
    bf16 = counts.bound_s(flops, nbytes, peak_flops=counts.PEAK_BF16_FLOPS)
    assert bf16 == nbytes / 3.35e12                # bound by bytes


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
