"""Plain PyTorch versions of the fused GRU kernel: one cell and the pair
of one m4 stage. Same math as `repro.nn.layers.gru_cell`."""
from __future__ import annotations

from ...nn.layers import gru_cell


def gru_cell_ref(x, h, wi, wh, bi, bh):
    return gru_cell({"wi": wi, "wh": wh, "bi": bi, "bh": bh}, x, h)


def gru_pair_ref(p_f, p_l, x_f, h_f, x_l, h_l):
    """The flow cell and the link cell of one stage, as two plain cells."""
    return gru_cell(p_f, x_f, h_f), gru_cell(p_l, x_l, h_l)
