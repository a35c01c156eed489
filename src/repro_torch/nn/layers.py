"""Plain layers on nested dicts of tensors, in the JAX package's layout.

Weights are stored `(d_in, d_out)` and applied as `x @ w + b`; GRU weights
are `(d_in, 3H)` / `(H, 3H)` with gate order r, z, n — the layout of
`repro.nn.layers`, so a JAX parameter tree loads unchanged (see
`repro_torch.weights`). Initialisers draw the same shapes and
distributions as the JAX ones from a `torch.Generator`, on the
generator's device; the numbers differ, since the two generators differ.

Dtype policy, as in the JAX package: parameters are created in `dtype`
(default float32); `apply` casts weights to the activation dtype, so one
tree serves float32 and bfloat16 activations.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from ..launch import sharding


# ---------------------------------------------------------------- helpers
def _cast(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return w.to(x.dtype) if w.dtype != x.dtype else w


def einsum(spec: str, *ops: torch.Tensor) -> torch.Tensor:
    """`torch.einsum` with `jnp.einsum`'s dtype rule: operands of mixed
    dtypes are promoted to their common dtype (bfloat16 with float32
    gives float32) before the product."""
    dtype = ops[0].dtype
    for op in ops[1:]:
        dtype = torch.promote_types(dtype, op.dtype)
    return torch.einsum(spec, *(op.to(dtype) for op in ops))


def _draw(gen: torch.Generator, shape, device=None) -> torch.Tensor:
    """An empty float32 tensor on the generator's device, to draw into; on
    the `meta` device when that is where the weight goes (no storage, and
    `torch.nn.init` draws nothing into it: JAX's `eval_shape`)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.empty(shape, dtype=torch.float32, device=gen.device)


# ---------------------------------------------------------------- init
def uniform_scale_init(gen: torch.Generator, shape, scale, *,
                       dtype=torch.float32, device=None) -> torch.Tensor:
    w = torch.nn.init.uniform_(_draw(gen, shape, device), -scale, scale,
                               generator=gen)
    return w.to(device=device, dtype=dtype)


def lecun_normal(gen: torch.Generator, shape, *, in_axis=-2,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times 1/sqrt(fan_in) (the
    size of axis `in_axis`), as `repro.nn.layers.lecun_normal` (the
    truncated draw is not rescaled)."""
    w = _draw(gen, shape, device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w / math.sqrt(shape[in_axis])).to(device=device, dtype=dtype)


def normal_init(gen: torch.Generator, shape, std=0.02, *,
                dtype=torch.float32, device=None) -> torch.Tensor:
    w = torch.nn.init.normal_(_draw(gen, shape, device), generator=gen)
    return (std * w).to(device=device, dtype=dtype)


def linear_init(gen: torch.Generator, d_in: int, d_out: int, *, bias=True,
                dtype=torch.float32, device=None) -> dict:
    p = {"w": lecun_normal(gen, (d_in, d_out), dtype=dtype, device=device)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype,
                             device=device or gen.device)
    return p


def mlp_init(gen: torch.Generator, sizes: Sequence[int], *, bias=True,
             device=None) -> dict:
    """sizes = [d_in, h1, ..., d_out]; relu between layers."""
    return {f"l{i}": linear_init(gen, sizes[i], sizes[i + 1], bias=bias,
                                 device=device)
            for i in range(len(sizes) - 1)}


def gru_init(gen: torch.Generator, d_in: int, d_h: int, *,
             device=None) -> dict:
    """GRU cell weights, uniform in ±1/sqrt(d_h), zero biases."""
    s = 1.0 / math.sqrt(d_h)
    return {
        "wi": uniform_scale_init(gen, (d_in, 3 * d_h), s, device=device),
        "wh": uniform_scale_init(gen, (d_h, 3 * d_h), s, device=device),
        "bi": torch.zeros(3 * d_h, dtype=torch.float32, device=device),
        "bh": torch.zeros(3 * d_h, dtype=torch.float32, device=device),
    }


def rmsnorm_init(d: int, *, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.zeros(d, dtype=dtype, device=device)}  # 1+scale


def layernorm_init(d: int, *, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def embedding_init(gen: torch.Generator, vocab: int, d: int, *,
                   dtype=torch.float32, device=None) -> dict:
    return {"table": normal_init(gen, (vocab, d), std=1.0 / math.sqrt(d),
                                 dtype=dtype, device=device)}


# ---------------------------------------------------------------- apply
def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ _cast(p["w"], x)
    if "b" in p:
        y = y + _cast(p["b"], x)
    return y


def mlp(p: dict, x: torch.Tensor, *, act=torch.relu) -> torch.Tensor:
    n = len(p)
    for i in range(n):
        x = linear(p[f"l{i}"], x)
        if i < n - 1:
            x = act(x)
    return x


def gru_cell(p: dict, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """x: (..., d_in), h: (..., d_h) -> new h. Gate order: r, z, n."""
    gi = x @ p["wi"] + p["bi"]
    gh = h @ p["wh"] + p["bh"]
    ir, iz, in_ = gi.chunk(3, dim=-1)
    hr, hz, hn = gh.chunk(3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(in_ + r * hn)
    return (1.0 - z) * n + z * h


def rmsnorm(p: dict, x: torch.Tensor, *, eps=1e-6) -> torch.Tensor:
    """Gemma-style RMSNorm, scaling by (1 + scale); normalised in float32
    and cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    nx = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return nx * (1.0 + _cast(p["scale"], x))


def layernorm(p: dict, x: torch.Tensor, *, eps=1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    nx = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    return nx * _cast(p["scale"], x) + _cast(p["bias"], x)


def embedding(p: dict, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    t = p["table"]
    if dtype is not None:
        t = t.to(dtype)
    # on DTensors each rank looks up its own ids in the whole table:
    # DTensor's rule for the lookup's backward (`index_put`) fails in
    # some torch versions
    return sharding.per_shard(lambda t, ids: t[ids], (t, ids),
                              ((None, None), (0, None)), ((0, None),))
