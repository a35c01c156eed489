"""The LM decode lane and its plain reference on the CPU, at the port's
smoke size of zamba2-2.7b (`configs.reduce_for_smoke`: d_model 64, 4
layers, a shared attention block every 2, float32):

- the port's `serve_step` over 16 decode steps from an empty state, and
  its `prefill_step`, against `portbench/reference/zamba2.py`'s full
  causal forward at every position;
- the prompt states that set-up makes with the reference's chunked
  forward against the port's own state after decoding the prompt token
  by token, and the chunked recurrence against the per-token one;
- the lane's call, from those states, against the full forward;
- the reference's float8 control fails that tolerance (at the cell's
  own widths it fails the cell's limits: `test_portbench_control.py`);
- the lane fails a run whose port config has other widths than the
  cell's file states;
- `correct` comes out false when the timed path is broken underneath:
  the rest of a run (set-up, window, reference, comparison) driven on
  the CPU with each fault the cell can have planted in the port (a step
  that returns its state unchanged, half the batch left out, a token
  altered where it is consumed). The cell runs on one chip, so no
  exchange between chips can be left out.
"""
import copy

import numpy as np
import pytest
import torch

from portbench.harness import lanes, runner, spec
from portbench.tests.conftest import LM, small_lm_cell, smoke_arch

# float32 on both sides, the same equations in another order: the
# recurrence against the chunked scan (prefill) and the per-step state
# (decode), a masked softmax over the cache's slots against a causal one
# over the positions. Measured at 1.3e-6 of the largest logit; 1e-5
# leaves room for other seeds and BLAS orders, and the float8 control
# reads ~0.7.
TOL = 1e-5
STEPS = 16


def _lane(cell):
    return lanes.lane(cell.traffic, cell.config)


def _weights(cell, seed):
    """The benchmark's weights, with every leaf that its rules draw as a
    constant (norm scales, biases, D, A_log) moved off it by a seeded
    perturbation, so that the comparison covers them."""
    lane = _lane(cell)
    w = lane.weights(seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    const = set(cell.config["init"])

    def shake(tree, key=None):
        if isinstance(tree, dict):
            return {k: shake(v, k) for k, v in tree.items()}
        if key in const and key != "table":
            return tree + 0.1 * torch.randn(tree.shape, generator=g)
        return tree
    return shake(w)


def _rel(got, ref):
    """max |got - ref| / max |ref| over the vocabulary, per row."""
    return ((got - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item()


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 17])
def test_serve_and_prefill_match_the_reference(monkeypatch, seed):
    from repro_torch.models import init_decode_state, prefill_step, \
        serve_step
    cell = small_lm_cell(monkeypatch, batch=2, prompt=4, steps=STEPS)
    cfg = smoke_arch(cell.config["arch"])
    lane = _lane(cell)
    w = _weights(cell, seed)
    tokens = torch.as_tensor(lane.pool(seed)[0])[:, :STEPS]
    with torch.no_grad():
        state = init_decode_state(cfg, 2, 20)
        got = []
        for t in range(STEPS):
            state, lg = serve_step(w, cfg, state,
                                   {"tokens": tokens[:, t:t + 1]})
            got.append(lg)
        got = torch.stack(got, 1)
        last = prefill_step(w, cfg, {"tokens": tokens})
    from portbench.lanes import lm_decode
    ref = lm_decode.reference_module(cell.config["reference"])
    every = list(range(STEPS))
    want = ref.logits(w, cell.config["model"], cell.config["constants"],
                      tokens, every)
    assert _rel(got, want) <= TOL
    assert _rel(last, want[:, -1]) <= TOL
    ctrl = ref.logits(w, cell.config["model"], cell.config["constants"],
                      tokens, every, control=True)
    assert _rel(ctrl, want) > TOL


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 19])
def test_prompt_states_are_the_ports_own_after_the_prompt(monkeypatch, seed):
    """20 prompt tokens, the smoke config's chunk of 8: three chunks, the
    last one short."""
    from repro_torch.models import init_decode_state, serve_step
    cell = small_lm_cell(monkeypatch, batch=2, prompt=20, steps=4)
    cfg = smoke_arch(cell.config["arch"])
    lane = _lane(cell)
    lane.params = w = _weights(cell, seed)
    batch = lane.pool(seed)[0]
    host, _ = lane.inputs(batch, "cpu")
    tokens = torch.as_tensor(batch)
    with torch.no_grad():
        state = init_decode_state(cfg, 2, lane.max_len)
        for t in range(20):
            state, _ = serve_step(w, cfg, state,
                                  {"tokens": tokens[:, t:t + 1]})
    assert int(host["cache_len"]) == int(state["cache_len"]) == 20
    for k in ("conv", "ssm", "k", "v"):
        scale = state[k].abs().max()
        assert (host[k] - state[k]).abs().max() <= TOL * scale, k


def test_chunked_recurrence_is_the_per_token_one():
    from portbench.lanes import lm_decode
    ref = lm_decode.reference_module("zamba2")
    g = torch.Generator().manual_seed(3)
    B, S, H, P, N = 2, 21, 3, 4, 5
    xh = torch.randn(B, S, H, P, generator=g)
    dt = torch.rand(B, S, H, generator=g)
    A = -torch.rand(H, generator=g) * 4
    Bm, Cm = torch.randn(B, S, N, generator=g), torch.randn(B, S, N,
                                                            generator=g)
    h0 = torch.randn(B, H, P, N, generator=g)
    y, h = ref.ssd(xh, dt, A, Bm, Cm, h0, 8)
    hh, ys = h0, []
    for t in range(S):
        hh = hh * torch.exp(dt[:, t] * A)[:, :, None, None] \
            + (dt[:, t, :, None] * xh[:, t])[..., None] \
            * Bm[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", hh, Cm[:, t]))
    torch.testing.assert_close(y, torch.stack(ys, 1), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, hh, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [6, 2 ** 31 + 23])
def test_lane_call_from_prompt_states_matches_the_reference(monkeypatch,
                                                           seed):
    cell = small_lm_cell(monkeypatch, batch=3, prompt=20, steps=STEPS)
    lane = _lane(cell)
    lane.params = w = _weights(cell, seed)
    batch = lane.pool(seed)[0]
    got, units, n = lane.call(lane.backend(w, "cpu"),
                              lane.inputs(batch, "cpu"))
    assert (units, n) == (3 * STEPS, 3)
    want, _ = lane.reference(batch, w, "cpu")
    assert got.shape == want.shape == (3, len(lane.keep),
                                       cell.config["model"]["vocab"])
    assert _rel(got, want) <= TOL
    numbers = lane.numbers([(0, got)], {0: want})
    assert max(numbers.values()) <= TOL


def test_lane_refuses_a_port_config_with_other_widths(monkeypatch):
    cell = small_lm_cell(monkeypatch)
    cell.config["model"]["d_model"] += 1
    with pytest.raises(RuntimeError, match="d_model"):
        _lane(cell).weights(1, "cpu")


def _run(cell):
    return runner.execute(cell, 2 ** 31 + 3, 0.0, False, 0.0,
                          log=lambda s: None, device="cpu")


def test_sound_run_is_correct(monkeypatch):
    cell = small_lm_cell(monkeypatch)
    result, checks = _run(cell)
    assert result["correct"], checks
    assert result["failed"] == 0
    assert result["attempted"] == 2 * cell.traffic["batch"]
    assert set(result["metrics"]) == {"tokens_per_s.lm", "setup_s"}


def _patch_step(monkeypatch, wrap):
    from repro_torch import models
    real = models.serve_step
    monkeypatch.setattr(models, "serve_step",
                        lambda p, cfg, state, batch, **kw:
                        wrap(real, p, cfg, state, batch, **kw))


def test_state_left_unchanged_is_caught(monkeypatch):
    cell = small_lm_cell(monkeypatch)

    def still(real, p, cfg, state, batch, **kw):
        old = dict(state)
        _, logits = real(p, cfg, state, batch, **kw)
        return old, logits
    _patch_step(monkeypatch, still)
    result, checks = _run(cell)
    assert not result["correct"], checks


def test_half_the_batch_left_out_is_caught(monkeypatch):
    cell = small_lm_cell(monkeypatch, batch=4)

    def half(real, p, cfg, state, batch, **kw):
        tok = batch["tokens"]
        h = tok.shape[0] // 2
        return real(p, cfg, state,
                    {"tokens": torch.cat([tok[:h], tok[:h]])}, **kw)
    _patch_step(monkeypatch, half)
    result, checks = _run(cell)
    assert not result["correct"], checks


def test_one_token_altered_is_caught(monkeypatch):
    cell = small_lm_cell(monkeypatch)
    vocab = cell.config["model"]["vocab"]

    def altered(real, p, cfg, state, batch, **kw):
        tok = batch["tokens"].clone()
        if int(state["cache_len"]) == cell.traffic["prompt"]:
            tok[-1] = (tok[-1] + 1) % vocab
        return real(p, cfg, state, {"tokens": tok}, **kw)
    _patch_step(monkeypatch, altered)
    result, checks = _run(cell)
    assert not result["correct"], checks


def test_every_lm_metric_reads_a_traced_cpu_run(monkeypatch):
    """A traced run on the CPU has no device operations: the readers of
    device time read nothing, the rest read a number."""
    cell = small_lm_cell(monkeypatch, trace=True)
    result, checks = runner.execute(cell, 2 ** 31 + 9, 0.0, True, 0.0,
                                    log=lambda s: None, device="cpu")
    assert result["correct"], checks
    assert "lm_step_us" not in result["metrics"]
    assert set(result["metrics"]) <= {m["name"] for m in cell.metrics}
    passes = 1 + _lane(cell).traced_passes
    assert result["attempted"] == passes * 2 * cell.traffic["batch"]


def test_pool_is_the_mixs_and_weights_the_seeds(monkeypatch):
    cell = small_lm_cell(monkeypatch)
    lane = _lane(cell)
    a, b = lane.pool(5), lane.pool(2 ** 31 + 5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    w1, w2 = lane.weights(5, "cpu"), lane.weights(5, "cpu")
    w3 = lane.weights(6, "cpu")
    q = ("shared_attn", "attn", "q", "w")

    def leaf(w):
        for k in q:
            w = w[k]
        return w
    assert torch.equal(leaf(w1), leaf(w2))
    assert not torch.equal(leaf(w1), leaf(w3))


def test_the_cell_reads_the_ports_full_config():
    """The cell's file states the port's own zamba2-2.7b, whole."""
    cell = copy.deepcopy(spec.find_cell(spec.load_benchmark(), LM, False))
    from portbench.lanes import lm_decode
    cfg = lm_decode.arch_config(cell.config)
    assert cfg.num_layers == 54 and cfg.d_model == 2560
