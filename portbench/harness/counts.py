"""The benchmark's yardstick of work: the operations and bytes each
function of the main path needs at its shapes, and the chip's peaks.

One NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full 700 W):
67 TFLOP/s in float32 on the CUDA cores, 989 TFLOP/s in bfloat16 on the
tensor cores, 3.35 TB/s of HBM3. A function's bound is the larger of
its operations over the rate of its precision and its bytes over the
last; each input byte is read once and each output
byte written once, whatever an implementation reads again. Each
mathematical operation counts once (a multiply and an add are two), at
the float32 rate: three TF32 passes that emulate one float32 product
count as that product.
"""
from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float,
            peak_flops: float = PEAK_FP32_FLOPS) -> float:
    return max(flops / peak_flops, nbytes / PEAK_BYTES_PER_S)


# ------------------------------------------------------------------ m4
def _dims(m: dict):
    H, G, C = m["hidden"], m["gnn_dim"], m["cfg_dim"]
    SF, SL = m["snap_flows"], m["snap_links"]
    return H, G, C, SF, SL


def gru_work(m: dict, B: int):
    """(flops, bytes) of one event's two fused GRU stages for B scenarios:
    GRU-1 and GRU-A over the time features (1 + 3 + C and 1 + 1 + C
    inputs), GRU-2 and GRU-B over the GNN's output (G + C); per cell the
    two products 2 r (d + H) 3H; bytes of the inputs, states, outputs,
    weights and biases."""
    H, G, C, SF, SL = _dims(m)
    cells = [(SF, 1 + 3 + C), (SL, 1 + 1 + C), (SF, G + C), (SL, G + C)]
    flops = sum(B * 2 * r * (d + H) * 3 * H for r, d in cells)
    nbytes = 4 * sum(B * (r * d + 2 * r * H) + (d + H) * 3 * H + 6 * H
                     for r, d in cells)
    return flops, nbytes


def gnn_work(m: dict, B: int, live_edges: float):
    """(flops, bytes) of one event's GraphSAGE rounds for B scenarios with
    `live_edges` live flow-link edges among them: per round the two
    products of each side, 2 (SF + SL) 2G G, and the sum of each live
    edge's message into both ends, 2 2 G; bytes per round of the two
    sides in and out, both layers' weights, and the edge list (two int64
    ids and a float32 mask an edge)."""
    H, G, C, SF, SL = _dims(m)
    R, P = m["gnn_layers"], m["max_path"]
    E = SF * P
    flops = R * (B * 2 * (SF + SL) * 2 * G * G + 2 * 2 * live_edges * G)
    nbytes = R * (4 * B * 2 * (SF + SL) * G + 4 * 2 * (2 * G * G + G)
                  + B * E * (8 + 8 + 4))
    return flops, nbytes


def m4_step_flops(m: dict, B: int, live_edges: float,
                  arrivals: float) -> float:
    """The model's operations in one event for B scenarios: both GRU
    stages, the projections into the GNN, its rounds, MLP-sldn over the
    snapshot's flows, and the arriving flows' MLP-init."""
    H, G, C, SF, SL = _dims(m)
    M = m["mlp_hidden"]
    proj = B * 2 * (SF + SL) * H * G
    sldn = B * SF * 2 * ((H + 1 + C) * M + M * M + M)
    init = arrivals * 2 * ((3 + C) * M + M * H)
    return (gru_work(m, B)[0] + proj + gnn_work(m, B, live_edges)[0]
            + sldn + init)


# ------------------------------------------------------------ flowSim
def waterfill_event_work(B: int, N: int, L: int, K: int, rounds, nnz):
    """(flops, bytes) of one water-filling event for B scenarios of N
    flows on L links: bytes of the function's inputs and outputs once,
    the incidence as one list of K links a flow (4 B N K), capacities
    (4 B L), the active mask (B N), rates (4 B N), rounds (4 B), capped
    (B); operations per scenario rounds_b (2 nnz_b + 3 L + 2 N): per round
    a link-sum add or count per incidence entry, a row-min compare per
    entry, a subtract, clamp and divide per link, and theta's min and the
    tie compare per flow."""
    nbytes = 4 * B * N * K + 4 * B * L + B * N + 4 * B * N + 4 * B + B
    flops = sum(int(r) * (2 * int(z) + 3 * L + 2 * N)
                for r, z in zip(rounds, nnz))
    return flops, nbytes


# ------------------------------------------------------------- LM decode
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def lm_decode_work(m: dict, c: dict, B: int, t: int):
    """(flops, bytes) of one decode step of the hybrid LM of widths `m`
    (a configuration's `model`) and constants `c` (`d_conv`), for B
    sequences at position t: each attends over the t + 1 positions up to
    its own, whatever number of slots an implementation keeps.

    Operations, each multiply and add once, of the products: per Mamba2
    layer the input projection 2 D (2 di + 2 N + Hs), the convolution
    2 K (di + 2 N), the state's update and readout (decay, dt x B^T, add;
    h C: 5 Hs P N) and the output projection 2 di D; per attention site
    the projections 2 D Dh (H + 2 Hkv) + 2 H Dh D, the scores and the
    weighted sum 4 H Dh (t + 1), the feed-forward 6 D F; the head 2 D V.
    Norms, activations, softplus and RoPE (under 0.5% of them) are left
    out. Bytes: every weight read once (of the embedding, the B rows
    looked up), the KV cache of each site read at its t positions and
    written at one, each SSM and convolution state read and written, the
    tokens in and the logits out."""
    if m["family"] != "hybrid" or m["moe"]:
        raise ValueError(f"no count of a {m['family']} LM's decode step")
    D, V, F = m["d_model"], m["vocab"], m["d_ff"]
    H, Hkv, Dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    di, N, P = m["ssm_expand"] * D, m["ssm_state"], m["ssm_head_dim"]
    Hs, K = di // P, c["d_conv"]
    Ls = m["num_layers"]
    sites = Ls // m["hybrid_attn_every"]
    w = DTYPE_BYTES[m["dtype"]]
    conv = di + 2 * N
    ssm_flops = (2 * D * (2 * di + 2 * N + Hs) + 2 * K * conv
                 + 5 * Hs * P * N + 2 * di * D)
    attn_flops = (2 * D * Dh * (H + 2 * Hkv) + 2 * H * Dh * D
                  + 4 * H * Dh * (t + 1) + 6 * D * F)
    flops = B * (Ls * ssm_flops + sites * attn_flops + 2 * D * V)
    ssm_params = (D * (2 * di + 2 * N + Hs) + K * conv + conv + 3 * Hs
                  + di + D + di * D)
    attn_params = D * Dh * (H + 2 * Hkv) + H * Dh * D + 3 * D * F + 2 * D
    params = Ls * ssm_params + attn_params + D + D * V + B * D
    kv = sites * B * 2 * Hkv * Dh * (t + 1)
    states = 2 * Ls * B * (Hs * P * N + (K - 1) * conv)
    nbytes = w * (params + kv + states + B * V) + 8 * B
    return flops, nbytes
