"""Sharding rules: DP across (pod, data), TP/EP/SP across model, as
`repro.launch.sharding`, line for line, on the port's tree paths.

Rules are expressed on the *trailing* dimensions of each parameter and
left-padded with None, so the same table covers plain layers, per-layer
stacked leaves (L, ...), and zamba2's doubly-stacked (G, E, ...) leaves.

TP:  attention qkv/ffn-in column-sharded, o/ffn-out row-sharded,
     vocab (embed table + lm head) sharded on model.
EP:  MoE expert tensors (E, D, F) sharded on the expert axis.
SP:  decode KV caches sequence-sharded on model (GQA kv-head counts are
     below the model-axis size, so sequence is the shardable axis);
     SSM decode states shard their head axis.
DP:  batch across (pod, data) when divisible (long_500k has B=1 ->
     replicated, the model axis still splits the work).

A spec is JAX's `PartitionSpec` as a tuple: per leading dimension one
mesh-axis name, a tuple of names, or None; `P()` replicates.
`placements(spec, mesh)` turns it into a DTensor's placements, one per
mesh dimension.

All the model's layers know of a mesh (the dry-run's DTensors) is in
the last five functions, the identity or a plain call on plain tensors:
`activation` (JAX's layout of an activation), `reduced` (a pending sum
reduced), `whole_heads`, `head_parts` and `per_shard` (JAX's
`shard_map`, by `local_map`), which runs a
computation independent per batch row and head on each rank's shards
where DTensor cannot shard it itself.
"""
from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..weights import tree_map, tree_map_with_path


def P(*dims):
    """The port's `PartitionSpec`; a one-name tuple is the name, as JAX
    canonicalises it."""
    return tuple(d[0] if isinstance(d, tuple) and len(d) == 1 else d
                 for d in dims)


def _trail(leaf_ndim, *spec):
    return P(*([None] * (leaf_ndim - len(spec)) + list(spec)))


def param_spec(path, leaf):
    """path: the leaf's path as `weights.tree_leaves` gives it
    ("blocks/attn/q/w"), leaf: a tensor (meta or fake will do)."""
    keys = path.split("/")
    nd = leaf.ndim

    if "embed" in keys and keys[-1] == "table":
        return _trail(nd, "model", None)
    if "lm_head" in keys and keys[-1] == "w":
        return _trail(nd, None, "model")
    # llama4-style shared expert: dense GLU rules (check BEFORE expert rule)
    if "shared" in keys and keys[-1] in ("wg", "wu"):
        return _trail(nd, None, "model")
    if "shared" in keys and keys[-1] == "wd":
        return _trail(nd, "model", None)
    # MoE experts: (..., E, D, F) / (..., E, F, D) -> shard E
    if "moe" in keys and keys[-1] in ("wg", "wu", "wd"):
        return _trail(nd, "model", None, None)
    # attention projections
    if keys[-1] == "w" and len(keys) >= 2:
        parent = keys[-2]
        if parent in ("q", "k", "v"):
            return _trail(nd, None, "model")
        if parent == "o":
            return _trail(nd, "model", None)
        if parent == "in_proj":      # mamba2
            return _trail(nd, None, "model")
        if parent == "out_proj":
            return _trail(nd, "model", None)
    # dense GLU ffn
    if "ffn" in keys and keys[-1] in ("wg", "wu"):
        return _trail(nd, None, "model")
    if "ffn" in keys and keys[-1] == "wd":
        return _trail(nd, "model", None)
    # mamba2 conv: depthwise over conv_dim
    if keys[-1] == "conv_w":
        return _trail(nd, None, "model")
    if keys[-1] == "conv_b":
        return _trail(nd, "model")
    # norms, biases, router, scalars: replicated
    return P()


def _axis_size(mesh, name):
    return mesh.size(mesh.mesh_dim_names.index(name))


def data_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def _batch_axes(mesh, batch_size):
    dp = data_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= _axis_size(mesh, a)
    return dp if batch_size % dp_size == 0 and batch_size >= dp_size \
        else None


def batch_spec(batch_tree, mesh, global_batch):
    """Spec tree for an input batch dict."""
    lead = _batch_axes(mesh, global_batch)

    def spec(leaf):
        if leaf.ndim == 0:
            return P()
        if leaf.ndim == 3 and leaf.shape[0] == 3:   # M-RoPE positions (3,B,S)
            return P(None, lead, *([None] * (leaf.ndim - 2)))
        return P(lead, *([None] * (leaf.ndim - 1)))

    return tree_map(spec, batch_tree)


def decode_state_spec(state_tree, mesh, cfg, batch_size):
    """KV caches (Lc,B,T,H,D): T on model; SSM states: head axis on model."""
    b_ax = _batch_axes(mesh, batch_size)
    msize = _axis_size(mesh, "model")

    def spec(path, leaf):
        name = path.split("/")[-1]
        if name in ("k", "v"):
            # (stack, B, T, Hkv, Dh): sequence-parallel on model
            t = leaf.shape[2]
            return P(None, b_ax, "model" if t % msize == 0 else None, None,
                     None)
        if name == "ssm":
            # (..., B, H, P, N): heads on model
            h = leaf.shape[-3]
            sp = [None] * leaf.ndim
            sp[-3] = "model" if h % msize == 0 else None
            sp[-4] = b_ax
            return P(*sp)
        if name == "conv":
            # (..., B, K, conv_dim): channels on model
            c = leaf.shape[-1]
            sp = [None] * leaf.ndim
            sp[-1] = "model" if c % msize == 0 else None
            sp[-3] = b_ax
            return P(*sp)
        return P()

    return tree_map_with_path(spec, state_tree)


def placements(spec, mesh):
    """A spec -> the DTensor placements on `mesh`: Shard(d) on each mesh
    dimension that names tensor dimension d, Replicate() elsewhere. A
    dimension sharded over several mesh axes lists them in the mesh's
    order, major first, as JAX's layout does."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} out of the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


# ------------------------------------------------- the layers, on DTensors
def _split_by(name, over):
    """Whether a computation's batch goes over mesh axis `name`: the data
    axes, or `over` alone where given."""
    return name in over if over else name != "model"


def activation(x):
    """A DTensor activation (B, S, D) in the layout JAX's rules give it:
    the batch over the data axes, replicated over `model` (Megatron's
    tensor parallelism: the row-parallel outputs are summed here). At the
    embedding, each sublayer's output and each layer boundary it keeps
    DTensor's op-by-op choices from drifting (to a replicated batch, or
    sums left pending through the residual). The identity on plain
    tensors."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, [Shard(0) if _split_by(a, ()) else
                                 Replicate() for a in mesh.mesh_dim_names])


def reduced(t):
    """`t` with its pending sums (Partial) reduced and its other
    placements kept; the identity on plain tensors. Torch 2.11's DTensor
    computes the gradient of a nonlinear op on a Partial operand (the
    log's) from each rank's unreduced share, so a sum goes through this
    before such an op."""
    if not isinstance(t, DTensor):
        return t
    keep = [Replicate() if p.is_partial() else p for p in t.placements]
    return t if keep == list(t.placements) else t.redistribute(t.device_mesh,
                                                               keep)


def whole_heads(t, heads):
    """`t` (..., heads * d), gathered on any mesh axis that splits its last
    dimension into parts that cut a head (GQA's few kv heads on a 16-wide
    `model` axis). The identity on plain tensors."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    keep = [Replicate() if p.is_shard(t.ndim - 1) and heads % mesh.size(i)
            else p for i, p in enumerate(t.placements)]
    return t if keep == list(t.placements) else t.redistribute(mesh, keep)


def head_parts(t):
    """The number of parts `per_shard` may split heads into for tensors on
    `t`'s mesh: the size of its `model` axis; 1 for a plain tensor."""
    mesh = t.device_mesh if isinstance(t, DTensor) else None
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index("model"))


# `per_shard` result markers: a result that is the sum of the heads' parts
# (its head entry), or the mean over the batch of each row's value (the
# whole entry)
SUM = "sum"
MEAN = "mean"


def per_shard(fn, args, dims, outs, *, heads=None, over=()):
    """`fn(*args)` for a computation independent per batch row and per
    head, run by each rank on its shards when an argument is a DTensor
    (plain tensors: one plain call). `dims[i]` is (batch dimension, head
    dimension) of `args[i]`, None where the argument has none, and `outs`
    the same for each result. The batch goes over the data axes (over the
    axes `over` alone, where given) where their sizes divide it, as
    `batch_spec` splits it, the heads over `model` where `heads` is given,
    no `over` is, and the axis's size divides it. With `heads`, `fn` takes
    the keyword `h0`: the index of the first of the heads it is handed (0
    for plain tensors and where the heads stay whole). An argument is
    replicated on an axis that splits the work but not the argument (one
    shared by all heads, or by all rows), and its gradient is summed there
    (Partial).

    Two results reduce across ranks. A head entry `SUM` is a result that
    sums over the heads: each rank's sum over its own heads, left a
    partial sum (Partial) on `model` for the caller's next layout to
    reduce. An entry `MEAN` is a mean over the batch rows: each rank's
    mean over its own rows, scaled by its share of the rows and summed
    over the axes that split them, so the result is the global mean,
    replicated, and each rank's gradient is its share of the global
    one (`fn` then returns a tuple)."""
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)),
                None)
    if mesh is None:
        return fn(*args) if heads is None else fn(*args, h0=0)
    names = mesh.mesh_dim_names
    parts = 1
    for i, name in enumerate(names):
        parts *= mesh.size(i) if _split_by(name, over) else 1
    split_batch = all(a.shape[d[0]] % parts == 0 for a, d in zip(args, dims)
                      if d[0] is not None)
    model = names.index("model") if "model" in names else None
    split_heads = (heads is not None and not over and model is not None
                   and heads % mesh.size(model) == 0)
    if heads is not None:
        fn = functools.partial(fn, h0=mesh.get_local_rank(model)
                               * (heads // mesh.size(model))
                               if split_heads else 0)

    def layout(d, grad=False):
        if d == MEAN:
            return tuple(Partial() if _split_by(name, over) and split_batch
                         else Replicate() for name in names)
        batch, head = d
        out = []
        for name in names:
            if _split_by(name, over):
                dim, splits = (batch, True) if split_batch else (None, False)
            elif name == "model" and split_heads and head == SUM:
                out.append(Partial())
                continue
            elif name == "model" and split_heads:
                dim, splits = head, True
            else:
                dim, splits = None, False
            out.append(Shard(dim) if dim is not None else
                       Partial() if grad and splits else Replicate())
        return tuple(out)

    share = 1.0 / parts if split_batch else 1.0

    def local(*args):
        res = fn(*(_ContiguousGrad.apply(a) if a.is_floating_point() else a
                   for a in args))
        if MEAN not in outs or share == 1.0:
            return res
        return tuple(r * share if d == MEAN else r for r, d in zip(res, outs))

    res = local_map(
        local, out_placements=tuple(layout(d) for d in outs),
        in_placements=tuple(layout(d) for d in dims),
        in_grad_placements=tuple(layout(d, grad=True) for d in dims),
        device_mesh=mesh, redistribute_inputs=True)(*args)
    if MEAN not in outs:
        return res
    return tuple(r.redistribute(mesh, [Replicate()] * len(names))
                 if d == MEAN else r for r, d in zip(res, outs))


class _ContiguousGrad(torch.autograd.Function):
    """The identity, with its gradient made contiguous: DTensor derives a
    local gradient's global layout from its strides, and the einsums'
    gradients come back transposed."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()
