"""The benchmark's yardstick of work: the operations and bytes each
function of the main path needs at its shapes, and the chip's peaks.

One NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full 700 W):
67 TFLOP/s in float32 on the CUDA cores, 3.35 TB/s of HBM3. A
function's bound is the larger of its operations over the first and its
bytes over the second; each input byte is read once and each output
byte written once, whatever an implementation reads again. Each
mathematical operation counts once (a multiply and an add are two), at
the float32 rate: three TF32 passes that emulate one float32 product
count as that product.
"""
from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)


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
