"""Multi-pod dry-run: prove the distribution config is coherent, as
`repro.launch.dryrun`, on DTensors.

For every (architecture x input-shape x mesh) cell, the step of
`make_steps` (train with clip and AdamW, prefill, or serve) runs once on
DTensors over a fake process group of 512 ranks (`mesh.init_fake_group`),
under `FakeTensorMode`: parameters from `init_params`, placed by
`param_spec`; the batch by `batch_spec`, the decode state by
`decode_state_spec`. Nothing is allocated and no communication runs. A
`TorchDispatchMode` records each collective DTensor emits, by its kind in
HLO's words and its bytes as the size of its result on one rank (JAX's
proxy); `FlopCounterMode` counts the FLOPs of one rank's local ops.

The census counts torch's collectives (DTensor's redistributions), not
XLA's: its bytes are the port's own. Torch has no counterpart of XLA's
fused "bytes accessed" or of its memory analysis, so `bytes_accessed` is
null and `memory` an error, as JAX writes for a backend that lacks them;
`lower_s` is the trace's wall (nothing compiles: `compile_s` is 0). The
plain tensors a step makes itself (positions, rope tables, masks,
constants), which a jitted JAX step holds replicated, count as replicated
(`implicit_replication`); every leaf of the parameters, moments, batch
and decode state must be a DTensor before the trace, so none is
replicated that way. An op meeting a sharding DTensor has no rule for
still raises, and its cell is a FAIL with DTensor's message; `main` exits
non-zero at the end if any cell failed. The model's layers take DTensors
through `launch.sharding`'s layer functions (JAX's activation layout;
attention, the SSD scan and the embedding lookup on each rank's
shards).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod both]
Results go to results/dryrun/<arch>_<shape>_<mesh>.json.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from contextlib import contextmanager

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import (TorchDispatchMode,
                                         _disable_current_modes)
from torch.utils.flop_counter import FlopCounterMode

from .. import configs
from ..models import lm
from ..optim import adamw_init, adamw_update, clip_by_global_norm
from ..runtime.resilience import remesh
from ..weights import tree_leaves, tree_map
from .mesh import init_fake_group, make_production_mesh
from .sharding import batch_spec, decode_state_spec, param_spec, placements
from .train import loss_and_grads

# c10d functional ops -> HLO's collective kinds
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
NO_MEMORY = {"error": "torch has no memory analysis of a traced step"}


def _bytes(tree):
    return sum(t.numel() * t.element_size() for _, t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class Census(TorchDispatchMode):
    """Records the collectives of the ops run under it, and the bytes every
    local op but a view reads and writes. DTensor ops pass through
    (NotImplemented),
    so DTensor desugars them into local ops and collectives first."""

    def __init__(self):
        super().__init__()
        self.kinds, self.total, self.op_bytes = {}, 0, 0
        self.calls = []                       # (bytes, kind, result shape)

    @property
    def ops(self):
        return len(self.calls)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            name = func._overloadpacket.__name__
            if name != "wait_tensor":
                kind = COLLECTIVE_KINDS.get(name, name)
                b = _bytes(out)
                self.kinds[kind] = self.kinds.get(kind, 0) + b
                self.total += b
                self.calls.append((b, kind, [tuple(t.shape) for _, t in
                                             tree_leaves(out)]))
        elif not func.is_view:                  # a view moves no bytes
            self.op_bytes += _bytes(list(args)) + _bytes(kwargs or {}) \
                + _bytes(out if isinstance(out, (list, tuple)) else [out])
        return out


def make_steps(cfg):
    def train_step(params, opt, batch):
        loss, grads = loss_and_grads(cfg, params, batch)
        with torch.no_grad():
            grads, gn = clip_by_global_norm(grads, 1.0)
            params, opt = adamw_update(params, grads, opt, lr=3e-4,
                                       weight_decay=0.1)
        return params, opt, loss

    @torch.no_grad()
    def prefill(params, batch):
        return lm.prefill_step(params, cfg, batch)

    @torch.no_grad()
    def serve(params, state, batch):
        return lm.serve_step(params, cfg, state, batch)

    return train_step, prefill, serve


def abstract_params(cfg):
    """`init_params` on the `meta` device: shapes and dtypes, no storage
    (JAX's `eval_shape`)."""
    return lm.init_params(torch.Generator(), cfg, device="meta")


def _fake(tree):
    """Fake tensors (the current mode's) for a tree of meta stand-ins."""
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype), tree)


def _distribute(tree, specs, mesh):
    return tree_map(lambda x, s: distribute_tensor(x, mesh,
                                                   placements(s, mesh)),
                    tree, specs)


@contextmanager
def _uncounted_propagation():
    """DTensor derives each op's output shape by running the op on fake
    tensors of the global shape (`ShardingPropagator`); that is no rank's
    work, so it runs with the counting modes off. Torch has no public
    hook for it, and its cache of those results (128 entries) is too
    small for a warm-up run to replace this; a torch without the method
    fails every cell loudly."""
    prop = ShardingPropagator
    orig = prop._propagate_tensor_meta_non_cached

    def quiet(self, op_schema):
        with _disable_current_modes():
            return orig(self, op_schema)
    prop._propagate_tensor_meta_non_cached = quiet
    try:
        yield
    finally:
        prop._propagate_tensor_meta_non_cached = orig


def _distributed(**trees):
    """Raise unless every leaf of each tree is a DTensor."""
    for name, tree in trees.items():
        for path, x in tree_leaves(tree):
            if not isinstance(x, DTensor):
                raise TypeError(f"{name} leaf {path} is not a DTensor: "
                                "the trace would replicate it")


def trace_cell(cfg, shape, mesh):
    """Run the cell's step once on fake DTensors over `mesh`; returns
    (census, FLOPs of one rank, wall s)."""
    S, B, kind = configs.SHAPES[shape]
    _, specs = configs.input_specs(cfg, shape)
    train_step, prefill, serve = make_steps(cfg)
    t0 = time.perf_counter()
    with FakeTensorMode():
        params = remesh(_fake(abstract_params(cfg)), param_spec, mesh)
        batch = _fake(specs["batch"])
        batch = _distribute(batch, batch_spec(batch, mesh, B), mesh)
        trees = {"params": params, "batch": batch}
        if kind == "train":             # the moments as their parameters
            opt = adamw_init(params)
            trees.update(m=opt["m"], v=opt["v"])
        elif kind == "decode":
            state = _fake(specs["state"])
            state = _distribute(state, decode_state_spec(state, mesh, cfg,
                                                         B), mesh)
            trees["state"] = state
        _distributed(**trees)
        census = Census()
        with FlopCounterMode(display=False) as flops, census, \
                implicit_replication(), _uncounted_propagation():
            if kind == "train":
                train_step(params, opt, batch)
            elif kind == "prefill":
                prefill(params, batch)
            else:
                serve(params, state, batch)
    return census, flops.get_total_flops(), time.perf_counter() - t0


def lower_cell(arch: str, shape: str, multi_pod: bool, verbose=True, *,
               cfg=None, mesh=None):
    """The cell's record. `cfg` and `mesh` default to the arch's config and
    the production mesh (16x16, or 2x16x16 with `multi_pod`)."""
    cfg = cfg or configs.get_config(arch)
    if not configs.shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape, "skipped":
                "long_500k needs sub-quadratic attention (DESIGN.md §9)"}
    if mesh is None:
        init_fake_group()
        mesh = make_production_mesh(multi_pod=multi_pod)
    S, B, kind = configs.SHAPES[shape]
    census, flops, wall = trace_cell(cfg, shape, mesh)
    rec = {
        "arch": arch, "shape": shape,
        "mesh": "x".join(str(n) for n in mesh.shape),
        "kind": kind, "seq": S, "batch": B,
        "devices": int(mesh.size()),
        "flops": flops,
        "bytes_accessed": None,
        "collective_bytes": census.total,
        "collective_ops": census.ops,
        "collective_kinds": census.kinds,
        "memory": NO_MEMORY,
        "lower_s": round(wall, 1), "compile_s": 0.0,
    }
    if verbose:
        print(json.dumps(rec, indent=1, default=str))
    return rec


def opt_overrides(cfg, shape):
    """Beyond-paper perf knobs (§Perf): Ulysses attention resharding over
    whichever mesh axes divide the batch + bf16 comm barriers."""
    S, B, kind = configs.SHAPES[shape]
    kw = dict(comm_barriers=True)
    # MEASURED on the JAX package's meshes: batch-sharded attention pays
    # for wide dense archs; for MoE (small d_model, huge vocab) the
    # induced FSDP-style f32 weight gathers cost more than the TP
    # activation all-reduces they replace -> skip.
    if kind in ("train", "prefill") and cfg.family == "dense":
        axes, rem = [], B
        if rem % 16 == 0:
            axes.append("data"); rem //= 16
        if rem % 16 == 0:
            axes.append("model"); rem //= 16
        if axes:
            kw["attn_batch_axes"] = tuple(axes)
    return cfg.with_(**kw)


def diagnose(arch, shape, top=20, optimized=False):
    """Print the top collective ops of a cell (perf loop)."""
    cfg = configs.get_config(arch)
    if optimized:
        cfg = opt_overrides(cfg, shape)
    init_fake_group()
    census, _, _ = trace_cell(cfg, shape,
                              make_production_mesh(multi_pod=False))
    print(f"== {arch} {shape}: {census.ops} collectives, "
          f"{census.total/1e9:.2f} GB (per-rank result bytes) ==")
    for k, v in sorted(census.kinds.items(), key=lambda kv: -kv[1]):
        print(f"  {k:20s} {v/1e9:8.3f} GB")
    for b, kind, shapes in sorted(census.calls, key=lambda c: -c[0])[:top]:
        print(f"  {b/1e6:10.1f} MB | {kind} {shapes}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["no", "yes", "both"], default="no")
    ap.add_argument("--diagnose", action="store_true",
                    help="print top collective ops for one cell")
    ap.add_argument("--optimized", action="store_true",
                    help="apply beyond-paper perf knobs (§Perf)")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)
    if args.diagnose:
        diagnose(args.arch, args.shape, optimized=args.optimized)
        return

    archs = configs.list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(configs.SHAPES) if (args.all or not args.shape) else [args.shape]
    pods = {"no": [False], "yes": [True], "both": [False, True]}[args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}"
                try:
                    rec = lower_cell(arch, shape, mp)
                    with open(os.path.join(args.out, tag + ".json"), "w") as f:
                        json.dump(rec, f, indent=1, default=str)
                    status = "SKIP" if "skipped" in rec else "OK"
                    print(f"[dryrun] {tag}: {status}")
                except Exception as e:
                    failures.append((tag, str(e)[:200]))
                    print(f"[dryrun] {tag}: FAIL {e}")
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")


if __name__ == "__main__":
    main()
