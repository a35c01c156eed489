"""Plain layers on nested dicts of tensors, in the JAX package's layout.

Weights are stored `(d_in, d_out)` and applied as `x @ w + b`; GRU weights
are `(d_in, 3H)` / `(H, 3H)` with gate order r, z, n — the layout of
`repro.nn.layers`, so a JAX parameter tree loads unchanged (see
`repro_torch.weights`). Initialisers draw the same shapes and
distributions as the JAX ones from a `torch.Generator`; the numbers
differ, since the two generators differ.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch


# ---------------------------------------------------------------- init
def lecun_normal(gen: torch.Generator, shape, *, device=None) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times 1/sqrt(fan_in), as
    `repro.nn.layers.lecun_normal` (the truncated draw is not rescaled)."""
    w = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w / math.sqrt(shape[-2])).to(device)


def linear_init(gen: torch.Generator, d_in: int, d_out: int, *, bias=True,
                device=None) -> dict:
    p = {"w": lecun_normal(gen, (d_in, d_out), device=device)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=torch.float32, device=device)
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

    def uniform(shape):
        w = torch.empty(shape, dtype=torch.float32)
        return torch.nn.init.uniform_(w, -s, s, generator=gen).to(device)

    return {
        "wi": uniform((d_in, 3 * d_h)),
        "wh": uniform((d_h, 3 * d_h)),
        "bi": torch.zeros(3 * d_h, dtype=torch.float32, device=device),
        "bh": torch.zeros(3 * d_h, dtype=torch.float32, device=device),
    }


# ---------------------------------------------------------------- apply
def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
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
