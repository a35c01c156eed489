"""The LM's decode on DTensors (`models.lm.serve_step`, the KV cache
written on each rank's slice of its time axis) and the SSM's causal
conv per shard, on the CPU. This file imports no JAX, so it runs
wherever the port does, under any torch:

- a real process group of 4 gloo ranks on a 2x2 (`data`, `model`) mesh,
  started by this file run as a script once per rank: `serve_step` of
  gemma2-9b (GQA, a sliding window on its local layers) and of
  zamba2-2.7b (the hybrid's shared attention) at `reduce_for_smoke`, on
  caches laid out by `launch.sharding.decode_state_spec` (time over
  `model`), for STEPS steps from an empty state of length MAX_LEN, past
  its end, against the plain single-process `serve_step` at rtol and
  atol 1e-5: every step's logits and the final state, whose layout stays
  `decode_state_spec`'s; and mamba2-1.3b's loss and every gradient
  (the causal conv and the SSD scan per shard) at rtol 1e-5 (an absolute
  floor of 1e-5 of each leaf's largest magnitude);
- the dry-run's `decode_32k` cells of an attention arch and an MoE arch,
  and the SSM's `train_4k` and `prefill_32k` cells, at `reduce_for_smoke`
  on a (2, 2) mesh of the fake process group: a non-empty census of
  HLO's kinds and FLOPs > 0.

The ranks meet through a `file://` store under the test's tmp_path, so
files run side by side under xdist never share a port.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores

from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, sharding  # noqa: E402
from repro_torch.launch.mesh import (init_fake_group,  # noqa: E402
                                     make_debug_mesh)
from repro_torch.launch.train import loss_and_grads  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.weights import tree_leaves  # noqa: E402

HLO_KINDS = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute"}
ARCHS = ("gemma2-9b", "zamba2-2.7b")
SSM_ARCH = "mamba2-1.3b"
RANKS = 4
B = 4
# past the cache's end by 4 steps, and past gemma2's smoke window of 8
MAX_LEN, STEPS = 8, 12


@pytest.mark.parametrize("arch,shape", [
    ("gemma2-9b", "decode_32k"), ("moonshot-v1-16b-a3b", "decode_32k"),
    ("mamba2-1.3b", "train_4k"), ("mamba2-1.3b", "prefill_32k"),
    ("zamba2-2.7b", "prefill_32k")])
def test_cell_traces(arch, shape):
    init_fake_group()
    # SSD chunks of 1024: the scan's op count falls with the chunks of S
    cfg = configs.reduce_for_smoke(configs.get_config(arch)).with_(
        ssm_chunk=1024)
    census, flops, _ = dryrun.trace_cell(cfg, shape, make_debug_mesh(2, 2))
    assert census.ops and census.kinds and set(census.kinds) <= HLO_KINDS
    assert flops > 0


# ------------------------------------------------- the gloo ranks' cases
def _results(mesh=None):
    """Every step's logits and the final state of each arch, plain or on
    DTensors over `mesh` (gathered whole): {name: numpy array}; on
    DTensors also, per arch, whether the final state kept
    `decode_state_spec`'s layout."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.runtime.resilience import remesh
    from repro_torch.weights import tree_map

    def whole(t):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        return t.detach().numpy()

    def spread(tree, specs):
        if mesh is None:
            return tree
        return tree_map(lambda x, s: distribute_tensor(
            x, mesh, sharding.placements(s, mesh)), tree, specs)

    out = {}
    for arch in ARCHS:
        cfg = configs.reduce_for_smoke(configs.get_config(arch))
        params = lm.init_params(torch.Generator().manual_seed(7), cfg)
        tokens = torch.from_numpy(np.random.default_rng(8).integers(
            0, cfg.vocab, (B, STEPS)))
        state = lm.init_decode_state(cfg, B, MAX_LEN)
        if mesh is not None:
            params = remesh(params, sharding.param_spec, mesh)
            spec = sharding.decode_state_spec(state, mesh, cfg, B)
            state = spread(state, spec)
        for t in range(STEPS):
            batch = {"tokens": tokens[:, t:t + 1]}
            batch = spread(batch, sharding.batch_spec(batch, mesh, B)
                           if mesh is not None else None)
            with torch.no_grad(), implicit_replication():
                state, lg = lm.serve_step(params, cfg, state, batch)
            out[f"{arch}/logits/{t}"] = whole(lg)
        for path, x in tree_leaves(state):
            out[f"{arch}/state/{path}"] = whole(x)
        if mesh is not None:
            kept = tree_map(lambda x, s: torch.tensor(
                tuple(x.placements) == tuple(sharding.placements(s, mesh))),
                state, spec)
            out[f"{arch}/layout_kept"] = np.array(all(
                bool(k) for _, k in tree_leaves(kept)))
    # the SSM's causal conv and scan per shard, through the loss and its
    # gradients
    cfg = configs.reduce_for_smoke(configs.get_config(SSM_ARCH))
    params = lm.init_params(torch.Generator().manual_seed(9), cfg)
    rng = np.random.default_rng(10)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, 16)))
             for k in ("tokens", "labels")}
    if mesh is not None:
        params = remesh(params, sharding.param_spec, mesh)
        batch = spread(batch, sharding.batch_spec(batch, mesh, B))
    with implicit_replication():
        loss, grads = loss_and_grads(cfg, params, batch)
    out[f"{SSM_ARCH}/loss"] = whole(loss)
    for path, g in tree_leaves(grads):
        out[f"{SSM_ARCH}/grad/{path}"] = whole(g)
    return out


def _rank_main(rank, store):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=RANKS)
    try:
        out = _results(make_debug_mesh(2, 2))
        if rank == 0:
            np.savez(os.path.join(os.path.dirname(store), "sharded.npz"),
                     **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo")
    store = d / "store"
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(store)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    with np.load(d / "sharded.npz") as f:
        return dict(f)


@pytest.fixture(scope="module")
def plain():
    return _results()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_on_four_gloo_ranks_equals_the_plain_decode(arch, sharded,
                                                           plain):
    keys = sorted(k for k in plain if k.startswith(f"{arch}/"))
    assert sorted(k for k in sharded if k.startswith(f"{arch}/")
                  and not k.endswith("/layout_kept")) == keys
    assert sum("/logits/" in k for k in keys) == STEPS
    assert {f"{arch}/state/{n}" for n in ("cache_len", "k", "v")} <= set(keys)
    for k in keys:
        assert sharded[k].shape == plain[k].shape, k
        np.testing.assert_allclose(sharded[k], plain[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert int(plain[f"{arch}/state/cache_len"]) == STEPS > MAX_LEN


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_keeps_its_layout(arch, sharded):
    assert bool(sharded[f"{arch}/layout_kept"])


def test_ssm_loss_and_every_gradient_on_four_gloo_ranks(sharded, plain):
    keys = sorted(k for k in plain if k.startswith(f"{SSM_ARCH}/"))
    assert sorted(k for k in sharded if k.startswith(f"{SSM_ARCH}/")) == keys
    assert {f"{SSM_ARCH}/grad/blocks/ssm/{n}" for n in (
        "conv_w", "conv_b", "in_proj/w", "A_log")} <= set(keys)
    for k in keys:
        want = plain[k]
        np.testing.assert_allclose(sharded[k], want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=k)
    assert np.abs(plain[f"{SSM_ARCH}/grad/blocks/ssm/conv_w"]).max() > 0


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2])
