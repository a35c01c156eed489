"""m4's weights, made by the benchmark from the seed on the device.

The tree has the layout the port's `M4Backend` takes (linears
{"w": (in, out), "b"}, GRU cells {"wi": (in, 3H), "wh": (H, 3H), "bi",
"bh"} with gate order r, z, n, MLPs {"l0", "l1", ...}) and the paper's
initialisers: linear weights standard normal truncated to [-2, 2] over
sqrt(fan_in), GRU weights uniform in +-1/sqrt(H), biases zero. They are
drawn in two calls (one truncated normal, one uniform) by a
`torch.Generator` on the card and cut into leaves, so set-up draws no
leaf on the host. The reference and the program get the same tree.
"""
from __future__ import annotations

import math

import torch


def shapes(m: dict) -> dict:
    """The tree's leaves as ("linear" | "gru", in, out) per path."""
    H, G, M, C = m["hidden"], m["gnn_dim"], m["mlp_hidden"], m["cfg_dim"]
    flow_feat, link_feat = 3, 1

    def mlp(sizes):
        return {f"l{i}": ("linear", sizes[i], sizes[i + 1])
                for i in range(len(sizes) - 1)}
    return {
        "flow_init": mlp([flow_feat + C, M, H]),
        "link_init": mlp([link_feat + C, M, H]),
        "gru1": ("gru", 1 + flow_feat + C, H),
        "gruA": ("gru", 1 + link_feat + C, H),
        "proj_f": ("linear", H, G),
        "proj_l": ("linear", H, G),
        "gnn": [{"wf": ("linear", 2 * G, G), "wl": ("linear", 2 * G, G)}
                for _ in range(m["gnn_layers"])],
        "gru2": ("gru", G + C, H),
        "gruB": ("gru", G + C, H),
        "mlp_sldn": mlp([H + 1 + C, M, M, 1]),
        "mlp_size": mlp([H, M, M, 1]),
        "mlp_queue": mlp([H, M, M, 1]),
    }


def _leaves(tree):
    if isinstance(tree, tuple):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        for v in tree:
            yield from _leaves(v)


def make(m: dict, seed: int, device) -> dict:
    """The weights of model config `m` from `seed`, float32 on `device`."""
    tree = shapes(m)
    n_normal = sum(i * o for kind, i, o in _leaves(tree) if kind == "linear")
    n_uniform = sum((i + o) * 3 * o for kind, i, o in _leaves(tree)
                    if kind == "gru")
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    normal = torch.empty(n_normal, device=device)
    torch.nn.init.trunc_normal_(normal, 0.0, 1.0, -2.0, 2.0, generator=g)
    uniform = torch.empty(n_uniform, device=device).uniform_(-1.0, 1.0,
                                                             generator=g)
    at = {"normal": 0, "uniform": 0}

    def take(pool, kind, n):
        x = pool[at[kind]:at[kind] + n]
        at[kind] += n
        return x

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v) for v in t]
        kind, i, o = t
        if kind == "linear":
            w = take(normal, "normal", i * o).view(i, o) / math.sqrt(i)
            return {"w": w, "b": torch.zeros(o, device=device)}
        s = 1.0 / math.sqrt(o)
        return {"wi": take(uniform, "uniform", i * 3 * o).view(i, 3 * o) * s,
                "wh": take(uniform, "uniform", o * 3 * o).view(o, 3 * o) * s,
                "bi": torch.zeros(3 * o, device=device),
                "bh": torch.zeros(3 * o, device=device)}
    return build(tree)
