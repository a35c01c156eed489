"""The arithmetic of the port's tensor-core kernels, emulated on the CPU.

`kernels/csrc/fused_gru.cu` and `kernels/csrc/bipartite.cu` take their
products in error-compensated TF32 ("3xTF32", `csrc/tf32x3.cuh`): each
float32 operand is split into hi = tf32(v) and lo = tf32(v - hi), with the
rounding of cvt.rna (to nearest, ties away from zero, on the low 13
mantissa bits; the kernels and `tf32` below take it as an integer add and
mask), and a * b is taken as a_hi b_hi + a_hi b_lo + a_lo b_hi with float32
accumulation. Products of two TF32 values are exact in float32, so a
float32 matmul of the split operands emulates the tensor cores up to the
order of the float32 sums.

Here that emulation runs at m4's full width (`init_m4(0)` weights, inputs
from numpy) for both GRU stages and one GNN round, and is held against the
plain float32 versions at the kernels' tolerances (1e-5 GRU, 1e-4 GNN). One
TF32 term misses 1e-5 at GRU stage 2: that is why the kernels take three.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores

from repro_torch.core.model import M4Config, init_m4  # noqa: E402
from repro_torch.kernels.bipartite import ref as bip_ref  # noqa: E402
from repro_torch.kernels.fused_gru import ref as gru_ref  # noqa: E402

GRU_TOL = 1e-5
GNN_TOL = 1e-4
CFG = M4Config()
PARAMS = init_m4(0, CFG)


def tf32(t):
    """cvt.rna.tf32.f32: round to nearest (ties away from zero) on the low
    13 mantissa bits, kept as float32."""
    u = t.contiguous().numpy().view(np.uint32)
    r = (u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return torch.from_numpy(r.view(np.float32))


def split(t):
    hi = tf32(t)
    return hi, tf32(t - hi)


def mm3(a, b):
    """a @ b as the kernels take it: big = a_hi b_hi, small = a_hi b_lo +
    a_lo b_hi, in separate float32 accumulators, then big + small."""
    (ah, al), (bh, bl) = split(a), split(b)
    return ah @ bh + (al @ bh + ah @ bl)


def mm1(a, b):
    """a @ b in plain TF32: one term."""
    return tf32(a) @ tf32(b)


def gru_emulated(p, x, h, mm):
    """The kernel's cell: r and z accumulate x@Wi and h@Wh together, `in`
    and `hn` apart; the biases join in the epilogue."""
    H = h.shape[-1]
    gx, gh = mm(x, p["wi"]), mm(h, p["wh"])
    b = p["bi"] + p["bh"]
    r = torch.sigmoid((gx[:, :H] + gh[:, :H]) + b[:H])
    z = torch.sigmoid((gx[:, H:2 * H] + gh[:, H:2 * H]) + b[H:2 * H])
    n = torch.tanh((gx[:, 2 * H:] + p["bi"][2 * H:])
                   + r * (gh[:, 2 * H:] + p["bh"][2 * H:]))
    return (1.0 - z) * n + z * h


def _stage_inputs(stage, rows, din, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, din)).astype(np.float32)
    if stage == 2:                       # [relu(GNN out) ; config vector]
        x[:, :CFG.gnn_dim] = np.maximum(x[:, :CFG.gnn_dim], 0.0)
    h = np.tanh(rng.normal(size=(rows, CFG.hidden))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(h)


STAGES = {1: (("gru1", CFG.snap_flows, 1 + CFG.flow_feat + CFG.cfg_dim),
              ("gruA", CFG.snap_links, 1 + CFG.link_feat + CFG.cfg_dim)),
          2: (("gru2", CFG.snap_flows, CFG.gnn_dim + CFG.cfg_dim),
              ("gruB", CFG.snap_links, CFG.gnn_dim + CFG.cfg_dim))}


@pytest.mark.parametrize("stage,cell", [(1, 0), (1, 1), (2, 0), (2, 1)])
def test_gru_3xtf32_holds_1e5_at_full_width(stage, cell):
    name, rows, din = STAGES[stage][cell]
    p = PARAMS[name]
    x, h = _stage_inputs(stage, rows, din, seed=10 * stage + cell)
    want = gru_ref.gru_cell_ref(x, h, p["wi"], p["wh"], p["bi"], p["bh"])
    got = gru_emulated(p, x, h, mm3)
    torch.testing.assert_close(got, want, rtol=GRU_TOL, atol=GRU_TOL)


def test_one_tf32_term_misses_1e5_at_stage2():
    worst = 0.0
    for name, rows, din in STAGES[2]:
        p = PARAMS[name]
        x, h = _stage_inputs(2, rows, din, seed=7)
        want = gru_ref.gru_cell_ref(x, h, p["wi"], p["wh"], p["bi"], p["bh"])
        err = (gru_emulated(p, x, h, mm1) - want).abs()
        worst = max(worst, float((err - GRU_TOL * want.abs()).max()))
    assert worst > GRU_TOL


def test_gnn_round_3xtf32_holds_1e4_at_full_width():
    SF, SL, G, P = CFG.snap_flows, CFG.snap_links, CFG.gnn_dim, CFG.max_path
    rng = np.random.default_rng(3)
    f = torch.from_numpy(np.maximum(rng.normal(size=(SF, G)), 0)
                         .astype(np.float32))
    l = torch.from_numpy(np.maximum(rng.normal(size=(SL, G)), 0)
                         .astype(np.float32))
    E = SF * P
    edge_f = torch.arange(SF).repeat_interleave(P)
    edge_l = torch.from_numpy(rng.integers(0, SL, E))
    edge_mask = torch.from_numpy((rng.random(E) < 0.7).astype(np.float32))
    layer = PARAMS["gnn"][0]
    want = bip_ref.bipartite_round_ref(f, l, edge_f, edge_l, edge_mask,
                                       layer["wf"]["w"], layer["wl"]["w"],
                                       layer["wf"]["b"], layer["wl"]["b"])
    # aggregation in float32 (the kernel's FMAs), product in 3xTF32
    m = bip_ref.incidence_from_edges(edge_f, edge_l, edge_mask, SF, SL)
    agg_f, agg_l = m @ l, m.t() @ f
    got = (torch.relu(mm3(torch.cat([f, agg_f], -1), layer["wf"]["w"])
                      + layer["wf"]["b"]),
           torch.relu(mm3(torch.cat([l, agg_l], -1), layer["wl"]["w"])
                      + layer["wl"]["b"]))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=GNN_TOL, atol=GNN_TOL)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                     # TF32 keeps 10 mantissa bits
    v = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0e-3], dtype=torch.float32)
    got = tf32(v)
    assert got[0] == one + ulp and got[1] == -(one + ulp)   # ties away
    assert got[2] == one and got[3] == one + ulp
    hi, lo = split(v)
    assert torch.equal(hi + lo, v)       # the split loses nothing here
