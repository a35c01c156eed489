"""The port's CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no CPU mode, so every test here needs an NVIDIA
GPU and skips without one; on a machine with a card run

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 1e-5 for the GRU pair, 1e-4 for the GNN rounds (those of
tests/test_kernels.py), none for the water-filling row-min (a min is
exact: bitwise) and for the per-event water-filling (its link sums are
exact: bitwise, rounds and capped too), 1e-4 relative for FCTs from the
card against the CPU (kernels and CPU BLAS sum in other orders). The
captured event loops (`repro_torch.core.compiled`) equal the eager ones
bitwise: the same kernels in the same order."""
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
from repro_torch.kernels.waterfill import layout as wf_layout  # noqa: E402
from repro_torch.kernels.waterfill import ops as wf_ops  # noqa: E402
from repro_torch.kernels.waterfill import ref as wf_ref  # noqa: E402
from repro_torch.net import FatTree, NetConfig  # noqa: E402
from repro_torch.sim import SimRequest, get_backend  # noqa: E402
from repro_torch.sim import run_closed_loop  # noqa: E402
from repro_torch.weights import tree_leaves  # noqa: E402

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
    n = wf_ops.waterfill_event.launches
    a = torch.ones(1, 8, 4, device=card)
    dispatch.waterfill_event(dispatch.waterfill_incidence(a),
                             torch.ones(1, 4, device=card),
                             torch.ones(1, 8, dtype=torch.bool, device=card),
                             max_rounds=32)
    assert wf_ops.waterfill_event.launches == n + 1


def test_kernels_refuse_inputs_that_require_grad(card):
    cfg = M4Config(**GATE)
    p = init_m4(0, cfg, device=card)
    x = torch.zeros(16, 13, device=card, requires_grad=True)
    h = torch.zeros(16, 16, device=card)
    xl, hl = torch.zeros(32, 11, device=card), torch.zeros(32, 16, device=card)
    f = torch.zeros(16, 16, device=card, requires_grad=True)
    l = torch.zeros(32, 16, device=card)
    e = torch.zeros(128, dtype=torch.long, device=card)
    m = torch.ones(128, device=card)
    counts = (gru_ops.gru_pair.launches, bip_ops.bipartite_round.launches,
              wf_ops.masked_rowmin.launches, wf_ops.waterfill_event.launches)
    with pytest.raises(RuntimeError, match="plain=True"):
        dispatch.gru_cell_pair(p["gru1"], p["gruA"], x, h, xl, hl)
    with pytest.raises(RuntimeError, match="plain=True"):
        dispatch.gnn_rounds(p["gnn"], f, l, e, e, m, 32)
    a = torch.ones(1, 8, 4, device=card)
    cap = torch.ones(1, 4, device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="plain=True"):
        dispatch.masked_rowmin(a, cap)
    with pytest.raises(RuntimeError, match="plain=True"):
        dispatch.waterfill_event(
            dispatch.waterfill_incidence(a), cap,
            torch.ones(1, 8, dtype=torch.bool, device=card), max_rounds=32)
    # the plain keyword keeps the differentiated step off the kernels
    fo, lo = dispatch.gru_cell_pair(p["gru1"], p["gruA"], x, h, xl, hl,
                                    plain=True)
    gf, gl = dispatch.gnn_rounds(p["gnn"], f, l, e, e, m, 32, plain=True)
    (fo.sum() + lo.sum() + gf.sum() + gl.sum()).backward()
    assert x.grad is not None and f.grad is not None
    assert counts == (gru_ops.gru_pair.launches,
                      bip_ops.bipartite_round.launches,
                      wf_ops.masked_rowmin.launches,
                      wf_ops.waterfill_event.launches)


def test_training_on_the_card_matches_the_cpu(card):
    """One per-sim update of `fit` at the gate scale on both devices from
    the same state: the losses at rtol 1e-4, and the parameters by the rule
    of tests/test_torch_training.py. AdamW's first step is about
    lr * sign(g) per element, so where the gradient is well determined
    (|g| above 1e-3 of its leaf's max; g read from the first moment,
    m = 0.1 g) the updates agree at rtol 1e-3, and anywhere they differ by
    at most 2 lr. No kernel is launched."""
    from repro_torch.core.events import build_event_batch
    from repro_torch.train import TrainConfig, fit, init_state
    cfg = M4Config(**GATE)
    batch = build_event_batch(
        get_backend("packet").run(SimRequest.from_scenario(
            sample_scenario(0, num_flows=30))).raw, cfg, max_events=40)
    tc = TrainConfig(epochs=1, lr=1e-3, shuffle=False)
    n = (gru_ops.gru_pair.launches, bip_ops.bipartite_round.launches)
    runs = [fit([batch], cfg, tc, state=init_state(cfg, 0, device="cpu"),
                device=d, log=lambda *a: None) for d in (card, "cpu")]
    assert n == (gru_ops.gru_pair.launches, bip_ops.bipartite_round.launches)
    (gs, gh), (cs, ch) = runs
    assert gs.step == cs.step == 1
    for k in ("loss", "sldn", "size", "queue", "grad_norm"):
        np.testing.assert_allclose(gh[0][k], ch[0][k], rtol=1e-4, err_msg=k)
    p0 = init_state(cfg, 0, device="cpu").params
    for (path, a), (_, b), (_, o), (_, m) in zip(
            tree_leaves(gs.params), tree_leaves(cs.params),
            tree_leaves(p0), tree_leaves(cs.opt["m"])):
        d_gpu, d_cpu = (a.cpu() - o).numpy(), (b - o).numpy()
        m = m.abs().numpy()
        big = m > 1e-3 * m.max()
        np.testing.assert_allclose(d_gpu[big], d_cpu[big], rtol=1e-3,
                                   atol=0.0, err_msg=path)
        assert np.abs(d_gpu - d_cpu).max() <= 2 * tc.lr * (1 + 1e-3), path


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

def _event_case(seed, B, N, L, real=None):
    """B scenarios of N flows over L links: 2-4 links per flow, every
    seventh flow on none, capacities 1-10 Gb/s, 70% of the flows active.
    `real` [(n, l), ...] pads scenario b past its n flows and l links, as
    run_many does (no links, capacity 1, padded flows active too)."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.rand(B, N, L, generator=g).argsort(-1)[..., :4]
    k = torch.randint(2, 5, (B, N, 1), generator=g)
    a = torch.zeros(B, N, L).scatter_(
        -1, idx, (torch.arange(4) < k).float())
    a[:, ::7] = 0.0
    cap = torch.rand(B, L, generator=g) * 9e9 + 1e9
    active = torch.rand(B, N, generator=g) < 0.7
    for b, (n, l) in enumerate(real or ()):
        a[b, n:] = 0.0
        a[b, :, l:] = 0.0
        cap[b, l:] = 1.0
        active[b, n:] = torch.rand(N - n, generator=g) < 0.5
    return a, cap, active


def _event_equal(card, a, cap, active):
    want = wf_ref.waterfill_event_ref(a.double(), cap, active)
    a_c = a.to(card)
    lists = wf_layout.incidence_lists(a_c)
    n = wf_ops.waterfill_event.launches
    got = wf_ops.waterfill_event(lists, cap.to(card), active.to(card))
    again = wf_ops.waterfill_event(lists, cap.to(card), active.to(card))
    torch.cuda.synchronize()
    assert wf_ops.waterfill_event.launches == n + 2
    for x, x2, w in zip(got, again, want):
        assert x.dtype == w.dtype and torch.equal(x.cpu(), w)
        assert torch.equal(x, x2)
    return want


@pytest.mark.parametrize("B,N,L", [(1, 2000, 80), (1, 2000, 96),
                                   (1, 2000, 128), (3, 129, 37),
                                   (2, 1, 1), (1, 40, 40)])
def test_waterfill_event_kernel_equals_plain_bitwise(card, B, N, L):
    _event_equal(card, *_event_case(N + L, B, N, L))


def test_waterfill_event_kernel_on_a_padded_batch(card):
    a, cap, active = _event_case(7, 4, 2000, 128,
                                 real=[(2000, 96), (1200, 80), (600, 128),
                                       (1900, 80)])
    _event_equal(card, a, cap, active)
    # padded flows only: every active flow has no link
    a[:, :] = 0.0
    _, rounds, capped = _event_equal(card, a, cap, active)
    assert capped.all() and (rounds == 32).all()


def test_waterfill_event_kernel_where_the_cap_binds(card):
    n = 40                      # each flow alone on a link: one per round
    a = torch.eye(n)[None]
    cap = torch.linspace(1e9, 10e9, n).flip(0)[None].contiguous()
    _, rounds, capped = _event_equal(card, a, cap,
                                     torch.ones(1, n, dtype=torch.bool))
    assert capped.all() and int(rounds) == 32


def test_waterfill_event_kernel_with_arrays_in_device_memory(card):
    """At 60000 flows the event does not fit in shared memory: the kernel
    reads the lists from its inputs and keeps the flow state in device
    memory."""
    N = 60000
    a, cap, active = _event_case(N, 1, N, 128)
    lists = wf_layout.incidence_lists(a)
    smem, scratch = wf_layout.plan(N, 128, lists.flow_links.shape[2],
                                   lists.nnz)
    assert smem == 0 and scratch > 0
    _event_equal(card, a, cap, active)


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
    n_event = wf_ops.waterfill_event.launches
    gpu = get_backend("flowsim_fast").run_many(reqs)
    assert wf_ops.waterfill_event.launches == n_event + 2 * 300
    assert wf_ops.masked_rowmin.launches == n
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


def test_run_chunked_of_mixed_topologies_matches_the_cpu(card):
    """One chunk of 8 smoke16 specs (four topologies, two workload
    families) padded into one batch on the card: m4 against the CPU at
    rtol 1e-4 (on FCTs up to one float32 ulp of the completion time, the
    resolution of m4's clock), flowsim_fast bitwise, one launch per
    batched event."""
    from repro_torch.scenarios import get_suite
    specs = list(get_suite("smoke16"))[:8]
    reqs = [s.to_request() for s in specs]
    assert len({(r.topo.num_racks, r.topo.hosts_per_rack) for r in reqs}) == 4
    events = 2 * max(r.num_flows for r in reqs)
    cfg = M4Config(**GATE)
    params = init_m4(0, cfg)
    n_gru, n_gnn = gru_ops.gru_pair.launches, bip_ops.bipartite_round.launches
    gpu = get_backend("m4", params=params, cfg=cfg).run_chunked(reqs, 8)
    assert gru_ops.gru_pair.launches == n_gru + 2 * events
    assert bip_ops.bipartite_round.launches == n_gnn + events
    cpu = get_backend("m4", params=params, cfg=cfg,
                      device="cpu").run_chunked(reqs, 8)
    for a, b, r in zip(gpu, cpu, reqs):
        assert np.isfinite(a.fcts).all() and (a.fcts > 0).all()
        done = np.array([f.t_arrival for f in r.flows]) + b.fcts
        ulp = np.spacing(done.astype(np.float32)).astype(np.float64)
        assert (np.abs(a.fcts - b.fcts) <= 1e-4 * b.fcts + ulp).all()
        np.testing.assert_allclose(a.fcts + done - b.fcts, done, rtol=1e-4)
    n_event = wf_ops.waterfill_event.launches
    gpu = get_backend("flowsim_fast").run_chunked(reqs, 8)
    assert wf_ops.waterfill_event.launches == n_event + events
    cpu = get_backend("flowsim_fast", device="cpu").run_chunked(reqs, 8)
    for a, b in zip(gpu, cpu):
        assert a.fcts.tobytes() == b.fcts.tobytes()


def test_probed_m4_on_the_card(card):
    """Probes on m4 add no kernel launch (2 GRU-pair and 1 GNN launch per
    event), leave the FCTs bitwise as unprobed, and give the CPU's series
    at rtol 1e-4 (the bar of FCTs across devices)."""
    import dataclasses
    from repro_torch.core.probes import ProbeConfig
    cfg = M4Config(**GATE)
    params = init_m4(0, cfg)
    req = SimRequest.from_scenario(sample_scenario(2, num_flows=60))
    probed = dataclasses.replace(req, probes=ProbeConfig(stride=3,
                                                         max_samples=16))
    backend = get_backend("m4", params=params, cfg=cfg)
    plain = backend.run(req)
    n_gru, n_gnn = gru_ops.gru_pair.launches, bip_ops.bipartite_round.launches
    got = backend.run(probed)
    assert gru_ops.gru_pair.launches == n_gru + 2 * 120
    assert bip_ops.bipartite_round.launches == n_gnn + 120
    assert got.fcts.tobytes() == plain.fcts.tobytes()
    assert got.probes["ev"].tolist() == list(range(72, 120, 3))
    cpu = get_backend("m4", params=params, cfg=cfg,
                      device="cpu").run(probed).probes
    np.testing.assert_array_equal(got.probes["ev"], cpu["ev"])
    for ch, v in got.probes["channels"].items():
        np.testing.assert_allclose(v, cpu["channels"][ch], rtol=1e-4,
                                   atol=1e-4 * np.abs(v).max(), err_msg=ch)


def test_probed_flowsim_fast_on_the_card(card):
    """One more water-filling launch per stride hit (the flow_rate
    channel), FCTs bitwise as unprobed, and the series bitwise as the
    CPU's (the water-filling is exact on both)."""
    import dataclasses
    from repro_torch.core.probes import ProbeConfig
    req = SimRequest.from_scenario(sample_scenario(1, num_flows=200))
    probed = dataclasses.replace(req, probes=ProbeConfig(stride=4,
                                                         max_samples=32))
    backend = get_backend("flowsim_fast")
    plain = backend.run(req)
    n_event = wf_ops.waterfill_event.launches
    n_rowmin = wf_ops.masked_rowmin.launches
    got = backend.run(probed)
    assert wf_ops.waterfill_event.launches == n_event + 400 + 100
    assert wf_ops.masked_rowmin.launches == n_rowmin
    assert got.fcts.tobytes() == plain.fcts.tobytes()
    cpu = get_backend("flowsim_fast", device="cpu").run(probed).probes
    np.testing.assert_array_equal(got.probes["t"], cpu["t"])
    for ch, v in got.probes["channels"].items():
        np.testing.assert_array_equal(v, cpu["channels"][ch], err_msg=ch)


def _probed(req, stride=3, samples=16):
    import dataclasses
    from repro_torch.core.probes import ProbeConfig
    return dataclasses.replace(req, probes=ProbeConfig(stride=stride,
                                                       max_samples=samples))


def _launch_counts():
    return (gru_ops.gru_pair.launches, bip_ops.bipartite_round.launches,
            wf_ops.waterfill_event.launches, wf_ops.masked_rowmin.launches)


def _series_equal(a, b):
    if a is None or b is None:
        return a is b
    return all(a[k].tobytes() == b[k].tobytes() for k in ("t", "ev")) and \
        all(v.tobytes() == b["channels"][ch].tobytes()
            for ch, v in a["channels"].items())


@pytest.mark.parametrize("name", ["m4", "flowsim_fast"])
@pytest.mark.parametrize("entry", ["run", "run_many", "probed run"])
def test_captured_loop_equals_eager_bitwise(card, name, entry):
    """The captured loop (one CUDA graph per arena shape, replayed) gives
    the eager loop's FCTs and probe rings bitwise, and its replays count
    the launches the eager loop makes: 2 GRU-pair and 1 GNN launch per m4
    event, 1 water-filling per flowsim_fast event (+ 1 per stride hit)."""
    from repro_torch.core import compiled
    cfg = M4Config(**GATE)
    backend = get_backend("m4", params=init_m4(0, cfg), cfg=cfg) \
        if name == "m4" else get_backend("flowsim_fast")
    reqs = [SimRequest.from_scenario(sample_scenario(s, num_flows=n))
            for s, n in ((2, 60), (3, 45), (4, 50))]
    if entry == "probed run":
        # 120 events at stride 7: 17 replays of a 7-event graph, a tail
        reqs = [_probed(reqs[0], stride=7)]
    call = (lambda: backend.run_many(reqs)) if entry == "run_many" else \
        (lambda: [backend.run(reqs[0])])
    compiled.clear_compiled()
    n0 = _launch_counts()
    first = call()                     # captures
    torch.cuda.synchronize()
    n1 = _launch_counts()
    again = call()                     # replays
    torch.cuda.synchronize()
    n2 = _launch_counts()
    with compiled.eager():
        eager = call()
    torch.cuda.synchronize()
    n3 = _launch_counts()
    per_call = [b - a for a, b in zip(n0, n1)]
    assert per_call == [b - a for a, b in zip(n1, n2)] == \
        [b - a for a, b in zip(n2, n3)]
    events = 2 * max(r.num_flows for r in reqs)
    hits = -(-events // 7) if entry == "probed run" else 0
    want = [2 * events, events, 0, 0] if name == "m4" else \
        [0, 0, events + hits, 0]
    assert per_call == want
    for a, b, c in zip(first, again, eager):
        assert a.fcts.tobytes() == b.fcts.tobytes() == c.fcts.tobytes()
        assert _series_equal(a.probes, c.probes)
        assert _series_equal(b.probes, c.probes)
    (e,) = compiled.entries()
    assert e["device"].startswith("cuda") and e["calls"] == 2
    assert e["graphs"] == (["group", "tail"] if entry == "probed run"
                           else ["event"])
    assert e["pool_bytes"] > 0 and e["buffer_bytes"] > 0


def test_capture_counts_once_per_shape(card):
    from repro_torch.core import compiled
    from repro_torch.core import flowsim_fast as tff
    from repro_torch.runtime.guards import RetraceError, no_retrace
    from repro_torch.scenarios import ScenarioSpec
    backend = get_backend("flowsim_fast")
    # one topology: the shape is the flow count alone
    reqs = [ScenarioSpec(num_flows=n, seed=s).to_request()
            for s, n in ((1, 40), (2, 40), (3, 41))]
    compiled.clear_compiled()
    c0 = dict(tff.TRACE_COUNTS)
    with no_retrace(allowed=1):
        backend.run(reqs[0])
    with no_retrace(allowed=0):
        backend.run(reqs[1])
    assert tff.TRACE_COUNTS["event_scan"] == c0.get("event_scan", 0) + 1
    with pytest.raises(RetraceError, match="event_scan: \\+1"):
        with no_retrace(allowed=0):
            backend.run(reqs[2])


def test_service_captures_once_per_bucket(card):
    """Two flushes of one flowsim_fast bucket on the card: one capture,
    no budget broken, every result bitwise as run_many of its padded
    batch."""
    from repro_torch.core import compiled
    from repro_torch.obs import get_registry
    from repro_torch.scenarios import ScenarioSpec
    from repro_torch.serve import ServeConfig, SimService
    backend = get_backend("flowsim_fast")
    reqs = [ScenarioSpec(num_flows=50, seed=s).to_request()
            for s in range(4)]                  # one bucket
    compiled.clear_compiled()
    viol = get_registry().snapshot()["counters"].get(
        "guards.no_retrace.violations", 0)
    with SimService(backend, config=ServeConfig(batch_size=2)) as service:
        got = []
        for pair in (reqs[:2], reqs[2:]):
            futs = [service.submit(r) for r in pair]
            got += [f.result(timeout=300) for f in futs]
        m = service.metrics()
    assert m["compiles"] == 1 and m["batches"] == 2
    assert m["isolated_retries"] == 0
    assert get_registry().snapshot()["counters"].get(
        "guards.no_retrace.violations", 0) == viol
    direct = backend.run_many(reqs[:2]) + backend.run_many(reqs[2:])
    for a, b in zip(got, direct):
        assert a.fcts.tobytes() == b.fcts.tobytes()


def test_flowsim_fast_fleet_equals_inprocess_on_card(card, tmp_path):
    """Two spawn workers, each with its own CUDA context on the card, fill
    the cache bitwise as an in-process sweep at the same chunk size; the
    workers rebuild the dispatcher's backend (fingerprint ends -kcuda),
    so they write the same keys."""
    from repro_torch.fleet import (FleetConfig, run_fleet, sweep_job_for,
                                   sweep_tasks)
    from repro_torch.scenarios import SweepRunner, get_suite
    from repro_torch.scenarios.cache import ResultCache, result_key
    backend = get_backend("flowsim_fast")
    assert backend.fingerprint().endswith("-kcuda")
    specs = list(get_suite("smoke16", num_flows=60).limit(8))
    reqs = [s.to_request() for s in specs]
    keys = [result_key(r, backend) for r in reqs]
    inline = str(tmp_path / "inline")
    SweepRunner(backend, cache_dir=inline, chunk_size=2).run(specs)
    job = sweep_job_for(backend, str(tmp_path / "fleet"))
    assert job.device == "cuda" and job.backend_kwargs == {"device": "cuda"}
    tasks = sweep_tasks(specs, reqs, keys, 2)
    metrics = run_fleet(tasks, job, FleetConfig(
        workers=2, coord_dir=str(tmp_path / "coord"), lease_timeout_s=30.0,
        chunk_timeout_s=300.0))
    assert metrics.done == metrics.total == 4 and metrics.poisoned == 0
    assert metrics.workers_spawned == 2
    fleet_store, ref = ResultCache(str(tmp_path / "fleet")), \
        ResultCache(inline)
    for k in keys:
        a, b = fleet_store.get(k), ref.get(k)
        assert a.fcts.tobytes() == b.fcts.tobytes()
        assert a.slowdowns.tobytes() == b.slowdowns.tobytes()
