"""Plain PyTorch reference of the repository's zamba2-2.7b, for the
benchmark's comparison: the full causal forward pass over a batch of
token sequences, every position at once.

The model as the repository defines it (arXiv:2411.15242, the Zamba2
suite, with the departures that the configuration's file lists under
`assumed`): a Mamba2 backbone of `num_layers` blocks in groups of
`hybrid_attn_every`, each group followed by ONE shared attention block
(the same weights at every site), then a final RMSNorm and the output
head.

- RMSNorm scales by (1 + scale), eps `constants.rms_eps`.
- Mamba2 block: x + out_proj(gated_norm(ssm(conv(in_proj(norm(x)))))).
  The input projection splits into z, x, B, C, dt; x, B and C pass a
  causal depthwise convolution of width `constants.d_conv` with bias,
  then SiLU; dt = softplus(dt + dt_bias), A = -exp(A_log). The SSM is
  the plain per-token recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t
  B_t^T, y_t = h_t C_t + D x_t (one group of B and C shared by the
  heads), then y * SiLU(z) through an RMSNorm.
- Attention block: x + o(attend(rope(q), rope(k), v)) over norm(x), the
  plain masked softmax over every earlier position (RoPE on each head's
  two halves); then x + wd(SiLU(wg h) * wu h) over h = norm(x).

`logits` runs in float32 with TF32 off, the recurrence per token. The
parameters are the tree that the benchmark made (the program's layout:
leaves with leading layer axes), each widened to float32 as its layer
runs. With `control=True` every matrix product's two inputs are rounded
to float8_e4m3fn, each tensor scaled by its largest magnitude to the
format's 448 first: the precision below the configuration's bfloat16.
With `bf16=True` they are rounded to bfloat16: a witness of what the
configuration's own precision reads, not a control.

`prompt_states` makes the inputs of a decode that starts after a
prompt: the states each layer holds after it, from the same forward
with the recurrence in chunks (`ssd`, the state-space dual form) and
TF32 products, which a batch of long prompts needs to fit a run's
set-up. Nothing here imports the program.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0           # the largest float8_e4m3fn


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8_e4m3fn under a per-tensor scale, in float32."""
    amax = x.abs().amax()
    if not bool(amax > 0):
        return x
    s = FP8_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


class Products:
    """The matrix products, in float32, or (the control) on float8
    inputs, or (a witness) on bfloat16 inputs."""

    def __init__(self, control: bool, bf16: bool = False):
        self.round = fp8 if control else bf16_round if bf16 else None

    def _in(self, *xs):
        return [self.round(x) for x in xs] if self.round else list(xs)

    def mm(self, a, w):
        a, w = self._in(a, w.float())
        return a @ w

    def einsum(self, spec, a, b):
        a, b = self._in(a, b)
        return torch.einsum(spec, a, b)


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def rope(x, theta):
    """x (B, S, H, D) rotated by position: the first half of each head
    against the second, angle pos / theta^(2i/D)."""
    S, D = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def ssd(xh, dt, A, Bm, Cm, h, chunk):
    """The same recurrence, `chunk` positions at a time (the state-space
    dual form): within a chunk y_t = C_t (exp(c_t) h + sum_{s <= t}
    exp(c_t - c_s) dt_s x_s B_s^T), c the running sum of dt A; float32
    products. Returns (y (B, S, H, P), the last state)."""
    S = xh.shape[1]
    ys = []
    for s0 in range(0, S, chunk):
        x, d = xh[:, s0:s0 + chunk], dt[:, s0:s0 + chunk]
        b, cm = Bm[:, s0:s0 + chunk], Cm[:, s0:s0 + chunk]
        cum = (d * A).cumsum(1)                               # (B, q, H)
        q = cum.shape[1]
        later = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
        seg = (cum[:, :, None] - cum[:, None]).masked_fill(
            ~later[None, :, :, None], -math.inf).exp()        # (B, t, s, H)
        w = seg * torch.einsum("btn,bsn->bts", cm, b)[..., None] \
            * d[:, None]
        ys.append(torch.einsum("bhpn,btn->bthp", h, cm)
                  * cum.exp()[..., None]
                  + torch.einsum("btsh,bshp->bthp", w, x))
        h = h * cum[:, -1].exp()[:, :, None, None] + torch.einsum(
            "bsh,bshp,bsn->bhpn", (cum[:, -1:] - cum).exp() * d, x, b)
    return torch.cat(ys, 1), h


def mamba2(p, x, m, c, ops, chunk=0):
    """One Mamba2 mixer over x (B, S, d_model), already normalised:
    (out, the convolution's last d_conv - 1 inputs, the last SSM state).
    The recurrence runs per token, or with `chunk` by `ssd`."""
    Bsz, S, _ = x.shape
    di, N = m["ssm_expand"] * m["d_model"], m["ssm_state"]
    P = m["ssm_head_dim"]
    H = di // P
    z, xr, Bm, Cm, dt = torch.split(ops.mm(x, p["in_proj"]["w"]),
                                    [di, di, N, N, H], -1)
    xbc = torch.cat([xr, Bm, Cm], -1)
    w, K = p["conv_w"].float(), c["d_conv"]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    tail = pad[:, S:]                                # (B, K - 1, conv)
    xbc = F.silu(sum(pad[:, i:i + S] * w[i] for i in range(K))
                 + p["conv_b"].float())
    xr, Bm, Cm = torch.split(xbc, [di, N, N], -1)
    dt = F.softplus(dt + p["dt_bias"].float())                # (B, S, H)
    A = -torch.exp(p["A_log"].float())
    xh = xr.reshape(Bsz, S, H, P)
    h = torch.zeros(Bsz, H, P, N, device=x.device)
    if chunk:
        y, h = ssd(xh, dt, A, Bm, Cm, h, chunk)
    else:
        ys = []
        for t in range(S):
            h = h * torch.exp(dt[:, t] * A)[:, :, None, None] \
                + (dt[:, t, :, None] * xh[:, t])[..., None] \
                * Bm[:, t, None, None, :]
            ys.append(ops.einsum("bhpn,bn->bhp", h, Cm[:, t]))
        y = torch.stack(ys, 1)
    y = y + xh * p["D"].float()[:, None]
    y = rmsnorm(y.reshape(Bsz, S, di) * F.silu(z), p["norm"]["scale"],
                c["rms_eps"])
    return ops.mm(y, p["out_proj"]["w"]), tail, h


def attention(p, x, m, ops):
    """Causal multi-head attention over x (B, S, d_model), normalised:
    (out, k after RoPE, v), k and v (B, S, Hkv, Dh)."""
    Bsz, S, _ = x.shape
    H, Hkv, Dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    q = ops.mm(x, p["q"]["w"]).reshape(Bsz, S, H, Dh)
    k = ops.mm(x, p["k"]["w"]).reshape(Bsz, S, Hkv, Dh)
    v = ops.mm(x, p["v"]["w"]).reshape(Bsz, S, Hkv, Dh)
    q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
    kh = k.repeat_interleave(H // Hkv, 2)    # q head i reads kv head i // g
    vh = v.repeat_interleave(H // Hkv, 2)
    s = ops.einsum("bshd,bthd->bhst", q, kh) / math.sqrt(Dh)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    w = torch.softmax(s.masked_fill(~causal, -math.inf), -1)
    out = ops.einsum("bhst,bthd->bshd", w, vh).reshape(Bsz, S, H * Dh)
    return ops.mm(out, p["o"]["w"]), k, v


def ffn(p, x, ops):
    return ops.mm(F.silu(ops.mm(x, p["wg"])) * ops.mm(x, p["wu"]), p["wd"])


def _at(tree, *idx):
    """The layer `idx` of a tree of stacked leaves."""
    if isinstance(tree, dict):
        return {k: _at(v, *idx) for k, v in tree.items()}
    return tree[idx]


def _check(m):
    if m["family"] != "hybrid" or m["act"] != "silu" or m["moe"] \
            or m["qk_norm"] or m["attn_softcap"] or m["final_softcap"] \
            or m["sliding_window"] or m["tie_embeddings"] \
            or m["embed_scale"]:
        raise ValueError("the zamba2 reference computes the hybrid as the "
                         "configuration states it, and nothing else")


def _backbone(params, m, c, tokens, ops, chunk=0, states=None):
    """The residual stream after the last layer; with `states` (a dict)
    each layer's last states are appended to its lists "conv", "ssm",
    "k" and "v"."""
    eps = c["rms_eps"]
    E = m["hybrid_attn_every"]
    shared = params["shared_attn"]
    x = params["embed"]["table"][tokens].float()
    for g in range(m["num_layers"] // E):
        for e in range(E):
            p = _at(params["blocks"], g, e)
            y, tail, h = mamba2(p["ssm"], rmsnorm(x, p["ln"]["scale"], eps),
                                m, c, ops, chunk)
            x = x + y
            if states is not None:
                states["conv"].append(tail)
                states["ssm"].append(h)
        y, k, v = attention(shared["attn"],
                            rmsnorm(x, shared["ln1"]["scale"], eps), m, ops)
        x = x + y
        if states is not None:
            states["k"].append(k)
            states["v"].append(v)
        x = x + ffn(shared["ffn"], rmsnorm(x, shared["ln2"]["scale"], eps),
                    ops)
    return x


def logits(params, model: dict, constants: dict, tokens, keep, *,
           control: bool = False, bf16: bool = False) -> torch.Tensor:
    """float32 logits (B, len(keep), vocab) at positions `keep` of the
    full causal forward over `tokens` (B, S). `bf16` rounds each
    product's inputs to bfloat16 in place of float8: not the control, a
    witness of what the configuration's own precision reads."""
    m, c = model, constants
    _check(m)
    ops = Products(control, bf16)
    with torch.no_grad(), matmul_precision(False):
        x = _backbone(params, m, c, tokens, ops)
        x = rmsnorm(x[:, list(keep)], params["final_norm"]["scale"],
                    c["rms_eps"])
        return ops.mm(x, params["lm_head"]["w"])[..., :m["vocab"]]


def prompt_states(params, model: dict, constants: dict, tokens, *,
                  chunk: int) -> dict:
    """The states that decoding the next token after `tokens` (B, S)
    reads, from the forward over them with the chunked recurrence
    (`ssd`), float32 with TF32 products: "conv" (L, B, d_conv - 1,
    conv), "ssm" (L, B, H, P, N) for the L Mamba2 layers in order, "k"
    and "v" (sites, B, S, Hkv, Dh), k after RoPE."""
    _check(model)
    states = {"conv": [], "ssm": [], "k": [], "v": []}
    with torch.no_grad(), matmul_precision(True):
        _backbone(params, model, constants, tokens, Products(False), chunk,
                  states)
    return {k: torch.stack(v) for k, v in states.items()}
