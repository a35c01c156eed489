"""The port's CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no CPU mode, so every test here needs an NVIDIA
GPU and skips without one; on a machine with a card run

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 1e-5 for the GRU pair, 1e-4 for the GNN round (those of
tests/test_kernels.py), 1e-4 relative for FCTs from the card against the
CPU (kernels and CPU BLAS sum in other orders)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.model import M4Config, init_m4  # noqa: E402
from repro_torch.data.traffic import sample_scenario  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.bipartite import ops as bip_ops  # noqa: E402
from repro_torch.kernels.bipartite import ref as bip_ref  # noqa: E402
from repro_torch.kernels.fused_gru import ops as gru_ops  # noqa: E402
from repro_torch.kernels.fused_gru import ref as gru_ref  # noqa: E402
from repro_torch.sim import SimRequest, get_backend  # noqa: E402

pytestmark = pytest.mark.cuda

GRU_TOL = 1e-5
GNN_TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _randn(g, *shape, scale=1.0):
    return torch.randn(*shape, generator=g) * scale


@pytest.mark.parametrize("Bf,Df,Bl,Dl,H", [
    (64, 13, 128, 11, 400), (64, 309, 128, 309, 400),   # full width
    (256, 309, 512, 309, 400),                           # run_many, B = 4
    (16, 13, 32, 11, 16), (5, 7, 3, 40, 20), (0, 13, 9, 11, 33)])
def test_gru_pair_kernel_matches_plain(card, Bf, Df, Bl, Dl, H):
    g = torch.Generator().manual_seed(Bf + Df + H)
    p = [{"wi": _randn(g, d, 3 * H, scale=H ** -0.5),
          "wh": _randn(g, H, 3 * H, scale=H ** -0.5),
          "bi": _randn(g, 3 * H, scale=0.1), "bh": _randn(g, 3 * H, scale=0.1)}
         for d in (Df, Dl)]
    xs = [_randn(g, Bf, Df), torch.tanh(_randn(g, Bf, H)),
          _randn(g, Bl, Dl), torch.tanh(_randn(g, Bl, H))]
    want = gru_ref.gru_pair_ref(p[0], p[1], *xs)
    on = lambda t: t.to(card)  # noqa: E731
    pc = [{k: on(v) for k, v in q.items()} for q in p]
    n = gru_ops.gru_pair.launches
    got = gru_ops.gru_pair(pc[0], pc[1], *map(on, xs))
    torch.cuda.synchronize()
    assert gru_ops.gru_pair.launches == n + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=GRU_TOL, atol=GRU_TOL)


@pytest.mark.parametrize("B,SF,SL,G,P", [
    (1, 64, 128, 300, 8), (4, 64, 128, 300, 8), (1, 16, 32, 16, 8),
    (2, 8, 16, 20, 4), (3, 32, 64, 600, 6)])
def test_bipartite_kernel_matches_plain(card, B, SF, SL, G, P):
    g = torch.Generator().manual_seed(SF * G)
    E = SF * P
    f, l = _randn(g, B, SF, G), _randn(g, B, SL, G)
    edge_f = torch.arange(SF).repeat_interleave(P)
    edge_l = torch.randint(0, SL, (B, E), generator=g)
    edge_mask = (torch.rand(B, E, generator=g) < 0.7).float()
    edge_l[:, ::3] = torch.where(edge_mask[:, ::3] > 0, edge_l[:, ::3], 0)
    w = [_randn(g, 2 * G, G, scale=(2 * G) ** -0.5) for _ in range(2)]
    b = [_randn(g, G, scale=0.1) for _ in range(2)]
    want = bip_ref.bipartite_round_ref(f, l, edge_f, edge_l, edge_mask,
                                       *w, *b)
    on = lambda t: t.to(card)  # noqa: E731
    got = bip_ops.bipartite_round(*map(on, (f, l, edge_f, edge_l,
                                            edge_mask, *w, *b)))
    n = bip_ops.bipartite_round.launches
    again = bip_ops.bipartite_round(*map(on, (f, l, edge_f, edge_l,
                                              edge_mask, *w, *b)))
    torch.cuda.synchronize()
    assert bip_ops.bipartite_round.launches == n + 1
    for a, a2, r in zip(got, again, want):
        torch.testing.assert_close(a.cpu(), r, rtol=GNN_TOL, atol=GNN_TOL)
        assert torch.equal(a, a2)          # fixed sum order: bitwise


def test_dispatch_sends_cuda_tensors_to_the_kernels(card):
    cfg = M4Config(hidden=16, gnn_dim=16, mlp_hidden=16, gnn_layers=2,
                   snap_flows=16, snap_links=32)
    p = init_m4(0, cfg, device=card)
    x = torch.zeros(16, 13, device=card)
    h = torch.zeros(16, 16, device=card)
    n = gru_ops.gru_pair.launches
    dispatch.gru_cell_pair(p["gru1"], p["gruA"], x, h,
                           torch.zeros(32, 11, device=card),
                           torch.zeros(32, 16, device=card))
    assert gru_ops.gru_pair.launches == n + 1
    n = bip_ops.bipartite_round.launches
    e = torch.zeros(128, dtype=torch.long, device=card)
    dispatch.gnn_rounds(p["gnn"], torch.zeros(16, 16, device=card),
                        torch.zeros(32, 16, device=card), e, e,
                        torch.ones(128, device=card), 32)
    assert bip_ops.bipartite_round.launches == n + 2


def test_run_on_the_card_matches_the_cpu(card):
    cfg = M4Config(hidden=16, gnn_dim=16, mlp_hidden=16, gnn_layers=2,
                   snap_flows=16, snap_links=32)
    params = init_m4(0, cfg)
    reqs = [SimRequest.from_scenario(sample_scenario(s, num_flows=60))
            for s in range(3)]
    gpu = get_backend("m4", params=params, cfg=cfg).run_many(reqs)
    cpu = get_backend("m4", params=params, cfg=cfg,
                      device="cpu").run_many(reqs)
    for a, b in zip(gpu, cpu):
        assert np.isfinite(a.fcts).all() and (a.fcts > 0).all()
        np.testing.assert_allclose(a.fcts, b.fcts, rtol=1e-4)
