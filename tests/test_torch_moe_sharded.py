"""The port's MoE layer on DTensors (`nn.moe.moe_forward` through
`launch.sharding.per_shard`), on the CPU:

- the dry-run's six MoE cells (moonshot-v1-16b-a3b and
  llama4-scout-17b-a16e at train_4k, prefill_32k and decode_32k) at
  `reduce_for_smoke` on a (2, 2) mesh of the fake process group: a
  non-empty census of HLO's kinds and FLOPs > 0;
- a real process group of 4 gloo ranks on a 2x2 (`data`, `model`) mesh,
  started by this file run as a script once per rank: `moe_forward`'s
  output and aux, and `launch.train.loss_and_grads`' loss and every
  gradient leaf (router, experts, the shared expert), against the plain
  single-process result at rtol 1e-5 (an absolute floor of 1e-5 of each
  leaf's largest magnitude, for the entries the ranks' partial sums
  leave near zero). The layer runs on groups split over `data` (16
  tokens a group), on one whole group (as at decode), and at a capacity
  factor that drops tokens.

The ranks meet through a `file://` store under the test's tmp_path, so
files run side by side under xdist never share a port.
"""
import os
import subprocess
import sys
from contextlib import contextmanager

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
from repro_torch.nn import moe  # noqa: E402
from repro_torch.weights import tree_leaves  # noqa: E402

HLO_KINDS = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute"}
ARCHS = ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e")
RANKS = 4
GROUP = 16                # tokens a group in the gloo cases
# (name, group size, capacity factor): groups over `data`, one whole
# group, and a capacity that drops choices
LAYER_CASES = (("groups", GROUP, 1.25), ("one_group", 64, 1.25),
               ("drops", GROUP, 0.5))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_cell_traces(arch, shape):
    init_fake_group()
    cfg = configs.reduce_for_smoke(configs.get_config(arch))
    census, flops, _ = dryrun.trace_cell(cfg, shape, make_debug_mesh(2, 2))
    assert census.ops and census.kinds and set(census.kinds) <= HLO_KINDS
    assert flops > 0


# ------------------------------------------------- the gloo ranks' cases
def _smoke(arch):
    return configs.reduce_for_smoke(configs.get_config(arch)).with_(
        num_layers=1)


def _moe_cfg(arch, group, capacity):
    return lm._moe_cfg(_smoke(arch))._replace(group_size=group,
                                              capacity_factor=capacity)


def _layer_inputs(arch, group, capacity):
    cfg = _moe_cfg(arch, group, capacity)
    p = moe.moe_init(torch.Generator().manual_seed(3), cfg)
    x = np.random.default_rng(4).standard_normal((4, 16, cfg.d_model))
    return cfg, p, torch.from_numpy(x.astype(np.float32))


def _lm_inputs(arch):
    cfg = _smoke(arch)
    params = lm.init_params(torch.Generator().manual_seed(5), cfg)
    rng = np.random.default_rng(6)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)))
             for k in ("tokens", "labels")}
    return cfg, params, batch


def _drops(cfg, p, x):
    """The choices past capacity in the plain layer."""
    N = x.shape[0] * x.shape[1]
    G = cfg.group_size if N % cfg.group_size == 0 else N
    _, _, pos_k, _, _ = moe._route(cfg, p["router"]["w"],
                                   x.reshape(N // G, G, -1))
    return int((pos_k >= moe._capacity(cfg, G)).sum())


@contextmanager
def _lm_grouped():
    """`lm._moe_cfg` with groups of GROUP tokens, so that a 4 x 16 batch
    makes groups for both data ranks."""
    orig = lm._moe_cfg
    lm._moe_cfg = lambda cfg: orig(cfg)._replace(group_size=GROUP)
    try:
        yield
    finally:
        lm._moe_cfg = orig


def _results(sharded_mesh=None):
    """Every case's numbers, plain, or on DTensors over `sharded_mesh`
    (gathered whole): {name: numpy array}."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.runtime.resilience import remesh

    def whole(t):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        return t.detach().numpy()

    def spread(x):
        if sharded_mesh is None:
            return x
        return distribute_tensor(x, sharded_mesh, sharding.placements(
            sharding.P("data"), sharded_mesh))

    out = {}
    for arch in ARCHS:
        for name, group, capacity in LAYER_CASES:
            cfg, p, x = _layer_inputs(arch, group, capacity)
            if sharded_mesh is not None:
                p = remesh({"moe": p}, sharding.param_spec,
                           sharded_mesh)["moe"]
            y, aux = moe.moe_forward(p, cfg, spread(x))
            out[f"{arch}/{name}/out"] = whole(sharding.activation(y))
            out[f"{arch}/{name}/aux"] = whole(aux)
        cfg, params, batch = _lm_inputs(arch)
        if sharded_mesh is not None:
            params = remesh(params, sharding.param_spec, sharded_mesh)
            batch = {k: spread(v) for k, v in batch.items()}
        # the plain tensors the step makes itself (positions, rope
        # tables) count as replicated, as in the dry-run
        with _lm_grouped(), implicit_replication():
            loss, grads = loss_and_grads(cfg, params, batch)
        out[f"{arch}/loss"] = whole(loss)
        for path, g in tree_leaves(grads):
            out[f"{arch}/grad/{path}"] = whole(g)
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


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("case", [c[0] for c in LAYER_CASES])
@pytest.mark.parametrize("arch", ARCHS)
def test_layer_on_four_gloo_ranks_equals_the_plain_layer(arch, case,
                                                         sharded, plain):
    for what in ("out", "aux"):
        key = f"{arch}/{case}/{what}"
        assert sharded[key].shape == plain[key].shape
        _close(sharded[key], plain[key], key)


def test_the_drop_case_drops_choices():
    _, group, capacity = LAYER_CASES[-1]
    for arch in ARCHS:
        assert _drops(*_layer_inputs(arch, group, capacity)) > 0, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_on_four_gloo_ranks(arch, sharded, plain):
    keys = sorted(k for k in plain if k.startswith(f"{arch}/"))
    assert sorted(k for k in sharded if k.startswith(f"{arch}/")) == keys
    names = {k.split("/grad/")[-1] for k in keys if "/grad/" in k}
    want = {"blocks/moe/router/w", "blocks/moe/wg", "blocks/moe/wu",
            "blocks/moe/wd"}
    if "llama4" in arch:
        want |= {"blocks/moe/shared/wg", "blocks/moe/shared/wu",
                 "blocks/moe/shared/wd"}
    assert want <= names
    for k in keys:
        if "/out" in k or "/aux" in k:
            continue
        _close(sharded[k], plain[k], k)
    # the router's gradient carries the aux loss's: not all zero
    assert np.abs(plain[f"{arch}/grad/blocks/moe/router/w"]).max() > 0


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2])
