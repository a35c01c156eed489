"""The port's CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no CPU mode, so every test here needs an NVIDIA
GPU and skips without one; on a machine with a card run

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 1e-5 for the GRU pair, 1e-4 for the GNN rounds (those of
tests/test_kernels.py), none for the water-filling row-min (a min is
exact: bitwise), 1e-4 relative for FCTs from the card against the CPU
(kernels and CPU BLAS sum in other orders)."""
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
from repro_torch.kernels.waterfill import ops as wf_ops  # noqa: E402
from repro_torch.kernels.waterfill import ref as wf_ref  # noqa: E402
from repro_torch.net import FatTree, NetConfig  # noqa: E402
from repro_torch.sim import SimRequest, get_backend  # noqa: E402
from repro_torch.sim import run_closed_loop  # noqa: E402

pytestmark = pytest.mark.cuda

GRU_TOL = 1e-5
GNN_TOL = 1e-4
GATE = dict(hidden=16, gnn_dim=16, mlp_hidden=16, gnn_layers=2,
            snap_flows=16, snap_links=32)


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
    (16, 13, 32, 11, 16), (5, 7, 3, 40, 20), (0, 13, 9, 11, 33),
    (64, 13, 128, 11, 401), (70, 45, 1, 300, 130)])        # ragged tiles
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
    again = gru_ops.gru_pair(pc[0], pc[1], *map(on, xs))
    torch.cuda.synchronize()
    assert gru_ops.gru_pair.launches == n + 2
    for a, a2, b in zip(got, again, want):
        torch.testing.assert_close(a.cpu(), b, rtol=GRU_TOL, atol=GRU_TOL)
        assert torch.equal(a, a2)          # fixed sum order: bitwise


def _edges(g, kind, B, SF, SL, P):
    """Edge lists of B snapshots: edge_f (E,), edge_l and edge_mask (B, E).
    random: m4's layout (edge e belongs to flow e // P), 70% live;
    hub: flow i's first edge goes to link 5, every other edge is masked,
    so one link row has a fan-in of SF and the rest none;
    shuffled: edge_f in no order; mixed: per-scenario live shares 0, 0.3,
    1 and 0.7 (B = 4)."""
    E = SF * P
    edge_f = torch.arange(SF).repeat_interleave(P)
    edge_l = torch.randint(0, SL, (B, E), generator=g)
    live = torch.rand(B, E, generator=g)
    if kind == "mixed":
        share = torch.tensor([0.0, 0.3, 1.0, 0.7])[:B, None]
    else:
        share = torch.full((B, 1), 0.7)
    edge_mask = (live < share).float()
    if kind == "hub":
        first = torch.arange(E) % P == 0
        edge_l[:, first] = 5
        edge_mask = first.float().expand(B, E).contiguous()
    if kind == "shuffled":
        edge_f = torch.randperm(E, generator=g) % SF
    # m4 points masked edges at link slot 0
    edge_l[:, ::3] = torch.where(edge_mask[:, ::3] > 0, edge_l[:, ::3], 0)
    return edge_f, edge_l, edge_mask


@pytest.mark.parametrize("B,SF,SL,G,P,R,kind", [
    (1, 64, 128, 300, 8, 1, "random"), (4, 64, 128, 300, 8, 1, "random"),
    (1, 16, 32, 16, 8, 1, "random"), (2, 8, 16, 20, 4, 1, "random"),
    (3, 32, 64, 600, 6, 1, "random"),
    # all rounds of an event in one launch, against the plain chain
    (1, 64, 128, 300, 8, 2, "random"), (1, 64, 128, 300, 8, 3, "random"),
    (4, 64, 128, 300, 8, 3, "mixed"), (1, 64, 128, 300, 8, 3, "hub"),
    (2, 16, 48, 37, 4, 2, "shuffled"), (1, 5, 33, 45, 3, 3, "random")])
def test_bipartite_kernel_matches_plain(card, B, SF, SL, G, P, R, kind):
    g = torch.Generator().manual_seed(SF * G + R)
    f, l = _randn(g, B, SF, G), _randn(g, B, SL, G)
    edge_f, edge_l, edge_mask = _edges(g, kind, B, SF, SL, P)
    layers = [{s: {"w": _randn(g, 2 * G, G, scale=(2 * G) ** -0.5),
                   "b": _randn(g, G, scale=0.1)} for s in ("wf", "wl")}
              for _ in range(R)]
    want = (f, l)
    for ly in layers:
        want = bip_ref.bipartite_round_ref(
            *want, edge_f, edge_l, edge_mask, ly["wf"]["w"], ly["wl"]["w"],
            ly["wf"]["b"], ly["wl"]["b"])
    on = lambda t: t.to(card)  # noqa: E731
    lc = [{s: {k: on(v) for k, v in ly[s].items()} for s in ly}
          for ly in layers]
    args = tuple(map(on, (f, l, edge_f, edge_l, edge_mask)))
    if R == 1:
        run = lambda: bip_ops.bipartite_round(  # noqa: E731
            *args, lc[0]["wf"]["w"], lc[0]["wl"]["w"], lc[0]["wf"]["b"],
            lc[0]["wl"]["b"])
    else:
        run = lambda: bip_ops.bipartite_rounds(lc, *args)  # noqa: E731
    got = run()
    n = bip_ops.bipartite_round.launches
    again = run()
    torch.cuda.synchronize()
    assert bip_ops.bipartite_round.launches == n + 1     # one per event
    for a, a2, r in zip(got, again, want):
        torch.testing.assert_close(a.cpu(), r, rtol=GNN_TOL, atol=GNN_TOL)
        assert torch.equal(a, a2)          # fixed sum order: bitwise


def test_dispatch_sends_cuda_tensors_to_the_kernels(card):
    cfg = M4Config(**GATE)
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
    assert bip_ops.bipartite_round.launches == n + 1     # all rounds
    n = wf_ops.masked_rowmin.launches
    dispatch.masked_rowmin(torch.ones(1, 8, 4, device=card),
                           torch.ones(1, 4, device=card))
    assert wf_ops.masked_rowmin.launches == n + 1


@pytest.mark.parametrize("B,F,L", [
    (1, 2000, 80), (1, 2000, 96), (1, 2000, 128), (4, 2000, 96),  # main path
    (1, 129, 37), (3, 1, 1), (2, 33, 300), (1, 64, 13000)])        # ragged
def test_rowmin_kernel_equals_plain_bitwise(card, B, F, L):
    g = torch.Generator().manual_seed(F + L)
    a = (torch.rand(B, F, L, generator=g) < 3.0 / L).float()
    a[:, ::9] = 0.0                                   # empty rows: INF
    share = torch.rand(B, L, generator=g) * 1e10
    share[:, ::4] = 1e30                              # links with no flow
    want = wf_ref.masked_rowmin_ref(a, share)
    n = wf_ops.masked_rowmin.launches
    got = wf_ops.masked_rowmin(a.to(card), share.to(card))
    torch.cuda.synchronize()
    assert wf_ops.masked_rowmin.launches == n + 1
    assert torch.equal(got.cpu(), want)

def test_run_on_the_card_matches_the_cpu(card):
    cfg = M4Config(**GATE)
    params = init_m4(0, cfg)
    reqs = [SimRequest.from_scenario(sample_scenario(s, num_flows=60))
            for s in range(3)]
    gpu = get_backend("m4", params=params, cfg=cfg).run_many(reqs)
    cpu = get_backend("m4", params=params, cfg=cfg,
                      device="cpu").run_many(reqs)
    for a, b in zip(gpu, cpu):
        assert np.isfinite(a.fcts).all() and (a.fcts > 0).all()
        np.testing.assert_allclose(a.fcts, b.fcts, rtol=1e-4)


def test_flowsim_fast_on_the_card_matches_the_cpu(card):
    reqs = [SimRequest.from_scenario(sample_scenario(s, num_flows=n))
            for s, n in ((1, 300), (2, 200), (3, 250))]
    n = wf_ops.masked_rowmin.launches
    gpu = get_backend("flowsim_fast").run_many(reqs)
    assert wf_ops.masked_rowmin.launches == n + 32 * 2 * 300
    cpu = get_backend("flowsim_fast", device="cpu").run_many(reqs)
    for a, b in zip(gpu, cpu):
        assert np.isfinite(a.fcts).all() and (a.fcts > 0).all()
        np.testing.assert_allclose(a.fcts, b.fcts, rtol=1e-4)


def test_m4_closed_loop_on_the_card_matches_the_cpu(card):
    from repro_torch.core.closedloop import make_backlog
    cfg = M4Config(**GATE)
    params = init_m4(0, cfg)
    topo = FatTree(8, 4, 2)
    backlog = make_backlog(topo, client_racks=2, flows_per_rack=15,
                           size_dist="WebServer", seed=1)
    res = [run_closed_loop(get_backend("m4", params=params, cfg=cfg,
                                       device=d), topo, NetConfig(),
                           backlog, 3) for d in ("cuda", "cpu")]
    assert np.isfinite(res[0].completion_times).all()
    np.testing.assert_allclose(res[0].completion_times,
                               res[1].completion_times, rtol=1e-4)
