"""The per-event water-filling kernel's layout and arithmetic, on the CPU.

The kernel (`csrc/waterfill.cu`, `waterfill_event_kernel`) runs only on
the card. What surrounds it runs here:

- `layout.incidence_lists` against a plain construction: ragged N and L,
  flows with no links, a padded batch; CSR lists ascending; each flow's
  entries in the lists of its links;
- `layout.lists_from_links` of the rows `_pack` writes from the flows'
  paths equals `incidence_lists` of the dense arena of those paths, field
  by field (ragged and padded batches, paths out of order or with a link
  twice, empty paths, padded links, a Table-2 scenario, every shard of a
  sharded batch), and `dense_incidence` of the rows is that arena;
- `layout.plan`: everything in shared memory at the main path's size,
  the lists and the flow state in device memory past it;
- `emulate`, a numpy copy of the kernel's arithmetic and control flow in
  its exact order (per link, a group of LINK_LANES lanes (read from the
  kernel's source) takes lane-stride float64 partial sums of the link's
  entries, then the xor tree; int counts; row-min; theta; the tie test;
  the freeze, written per flow and per entry; the early stop),
  equals `waterfill_event_ref` bitwise in rates, rounds and capped on the
  states of the first 300 events of the 2000-flow `sample_scenario(1)`
  and of a padded `run_many` batch. Its float64 link sums equal
  `math.fsum` of the same addends, and every addition in them is exact
  (TwoSum error 0): the premise that makes any summation order, the plain
  version's `bmm` included, give the same float32 sums.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores

from repro_torch.core import flowsim_fast as tff  # noqa: E402
from repro_torch.core import sharding  # noqa: E402
from repro_torch.data.traffic import sample_scenario  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.waterfill import layout, ref  # noqa: E402
from repro_torch.net import FatTree, Flow  # noqa: E402

F32 = np.float32
CSRC = Path(layout.__file__).resolve().parents[1] / "csrc" / "waterfill.cu"
LINK_LANES = int(re.search(r"constexpr int LINK_LANES = (\d+);",
                           CSRC.read_text()).group(1))


def _plain_lists(a):
    """Per-flow and per-link lists of a (B, N, L) numpy incidence."""
    B, N, L = a.shape
    flow = [[np.flatnonzero(a[b, f]).tolist() for f in range(N)]
            for b in range(B)]
    link = [[np.flatnonzero(a[b, :, l]).tolist() for l in range(L)]
            for b in range(B)]
    return flow, link


@pytest.mark.parametrize("B,N,L", [(1, 7, 5), (3, 40, 13), (2, 1, 1),
                                   (4, 65, 33), (1, 300, 96)])
def test_incidence_lists_match_a_plain_construction(B, N, L):
    rng = np.random.default_rng(B * N + L)
    a = (rng.random((B, N, L)) < min(1.0, 3.0 / L)).astype(np.float32)
    a[:, ::4] = 0.0                                 # flows with no links
    if B > 1:
        a[-1, N // 2:] = 0.0                        # a padded scenario
        a[0, :, L // 2:] = 0.0                      # padded links
    lists = layout.incidence_lists(torch.from_numpy(a))
    flow, link = _plain_lists(a)
    K = max((len(x) for per in flow for x in per), default=0)
    assert lists.flow_links.shape == (B, N, K)
    assert lists.flow_links.dtype == torch.int32
    nnz = [sum(len(x) for x in per) for per in link]
    assert lists.nnz == max(nnz)
    for b in range(B):
        for f in range(N):
            got = lists.flow_links[b, f].tolist()
            assert got == flow[b][f] + [-1] * (K - len(flow[b][f]))
        ptr = lists.link_ptr[b].tolist()
        assert ptr[0] == 0 and ptr[-1] == nnz[b]
        # the flow of each entry, from the flows' entries: every entry
        # named once, each in the range of one of its flow's links
        fl, fe = lists.flow_links[b], lists.flow_entries[b]
        assert fe.shape == (N, K) and torch.equal(fe < 0, fl < 0)
        flow_of = [None] * nnz[b]
        for f in range(N):
            for l, j in zip(fl[f].tolist(), fe[f].tolist()):
                if l >= 0:
                    assert ptr[l] <= j < ptr[l + 1] and flow_of[j] is None
                    flow_of[j] = f
        # each link's range lists its flows, ascending
        for l in range(L):
            got = flow_of[ptr[l]:ptr[l + 1]]
            assert got == link[b][l] and got == sorted(got)


def test_incidence_lists_of_the_table2_scenarios():
    sc = sample_scenario(1)
    links, cap, *_ = tff._to_device([tff._pack(sc.topo, sc.generate())],
                                    "cpu")
    a = layout.dense_incidence(links, cap.shape[1])
    lists = layout.incidence_lists(a)
    hops = (a[0] > 0).sum(-1)
    assert lists.flow_links.shape == (1, 2000, int(hops.max()))
    assert int(lists.link_ptr[0, -1]) == int(hops.sum())
    smem, scratch = layout.plan(2000, a.shape[2],
                                lists.flow_links.shape[2], lists.nnz)
    assert scratch == 0 and 0 < smem <= layout.SMEM_BUDGET


def _sampled(*seeds_flows):
    out = []
    for seed, n in seeds_flows:
        sc = sample_scenario(seed, num_flows=n)
        out.append((sc.topo, sc.generate()))
    return out


def _by_hand(paths):
    """Flows on a 12-link fat tree with the given paths, as given."""
    topo = FatTree(num_racks=2, hosts_per_rack=2, num_spines=1)
    return topo, [Flow(fid=i, src=0, dst=1, size=1000 * (i + 1),
                       t_arrival=1e-6 * i, path=list(p))
                  for i, p in enumerate(paths)]


# name -> (scenarios, extra padded flows, extra padded links, shards)
LIST_CASES = {
    "ragged_padded": lambda: (_sampled((0, 40), (5, 25), (2, 12), (9, 33)),
                              0, 0, None),
    "unordered_repeated": lambda: ([_by_hand([[5, 1], [3, 1, 3],
                                              [7, 2, 2, 0], [11, 4, 9, 6],
                                              [1]])], 0, 0, None),
    "empty_paths": lambda: ([_by_hand([[], [2, 0], [], [4, 9, 1, 6], []]),
                             _by_hand([[], []])], 2, 0, None),
    "padded_links": lambda: (_sampled((4, 30)), 0, 7, None),
    "table2": lambda: ([(sample_scenario(1).topo,
                         sample_scenario(1).generate())], 0, 0, None),
    "shards_2": lambda: (_sampled((0, 40), (5, 25)) + [
        _by_hand([[1], [0, 2]])] + _sampled((2, 12), (9, 33)), 0, 0, 2),
    # the middle shard's paths are shorter than the batch's longest
    "shards_3": lambda: (_sampled((0, 40), (5, 25)) + [
        _by_hand([[1], [0, 2]]), _by_hand([[3]])] + _sampled((2, 12)),
        0, 0, 3),
}


@pytest.mark.parametrize("case", sorted(LIST_CASES))
def test_lists_from_paths_equal_the_dense_oracle(case):
    """The lists built from the rows `_pack` writes equal, field by field,
    `incidence_lists` of the dense arena the paths give (`a[fid, path] =
    1`), for the batch or for every shard of it."""
    scenarios, more_n, more_l, shards = LIST_CASES[case]()
    N = max(len(flows) for _, flows in scenarios) + more_n
    L = max(topo.num_links for topo, _ in scenarios) + more_l
    links, cap, *_ = tff._to_device(
        [tff._pack(topo, flows, n_total=N, l_total=L)
         for topo, flows in scenarios], "cpu")
    a = np.zeros((len(scenarios), N, L), np.float32)
    for b, (_, flows) in enumerate(scenarios):
        for f in flows:
            a[b, f.fid, f.path] = 1.0
    a = torch.from_numpy(a)
    assert cap.shape == (len(scenarios), L)
    assert torch.equal(layout.dense_incidence(links, L), a)
    assert torch.equal(dispatch.waterfill_incidence(links, L), a.double())
    pairs = [(links, a)] if shards is None else list(zip(
        sharding.shard_leaves(links, shards),
        sharding.shard_leaves(a, shards)))
    for rows, dense in pairs:
        got = layout.lists_from_links(rows, L)
        want = layout.incidence_lists(dense)
        for name, x, y in zip(got._fields, got, want):
            if name == "nnz":
                assert x == y
            else:
                assert x.dtype == y.dtype and torch.equal(x, y), name


def test_plan_moves_arrays_to_device_memory_past_shared_memory():
    """Every array in shared memory at the main path's size; past it, the
    lists and the flow state in device memory, and in shared memory
    nothing."""
    smem, scratch = layout.plan(2000, 96, 4, 7000)
    assert scratch == 0
    assert smem == 4 * (97 + 96 + 96 + 2000 + 7000 + 8000 + 2000 + 8000) + 12
    smem, scratch = layout.plan(60000, 128, 4, 240000)
    assert smem == 0
    assert scratch == 4 * (128 + 240000 + 60000)     # share, entry, fshare


# ---------------------------------------------------------------- emulation

def _two_sum_error(s, a, b):
    """The rounding error of s = a + b (Knuth's TwoSum), elementwise."""
    bb = s - a
    return (a - (s - bb)) + (b - bb)


def emulate(lists, cap, active, *, max_rounds=ref.MAX_ROUNDS, sums=None):
    """The event kernel's arithmetic and control flow, one scenario at a
    time, in its order. lists: `incidence_lists` of (B, N, L); cap (B, L),
    active (B, N), numpy. Returns (rates, rounds, capped) as the kernel
    writes them; with a list `sums`, appends each round's (addends (L, M,
    G) float64, used (L,)), G = LINK_LANES.

    As in the kernel, a flow's state is one float32, -0.0 while unfrozen,
    kept per flow and per entry of the CSR lists; each pass sums each
    link's entries, computes the bottleneck shares, theta and the count of
    unfrozen flows, and, while one is left and fewer than `max_rounds`
    rounds have run, freezes (writing both copies)."""
    flow_links = lists.flow_links.numpy()
    flow_entries = lists.flow_entries.numpy()
    link_ptr = lists.link_ptr.numpy()
    B, N, K = flow_links.shape
    L = link_ptr.shape[1] - 1
    out = np.zeros((B, N), F32)
    rounds = np.zeros(B, np.int32)
    capped = np.zeros(B, bool)
    G = LINK_LANES
    lane_of = np.arange(G)
    tie = F32(ref.TIE)
    for b in range(B):
        deg = np.diff(link_ptr[b])
        M = max(1, -(-int(deg.max(initial=0)) // G))
        # slot [l, m, lane] is entry m * G + lane of link l's list
        slots = np.full((L, M * G), -1, np.int64)
        for l in range(L):
            slots[l, :deg[l]] = np.arange(link_ptr[b, l], link_ptr[b, l + 1])
        slots = slots.reshape(L, M, G)
        live = slots >= 0
        rate = np.where(active[b], F32(-0.0), F32(0.0))
        entry = np.zeros(max(1, int(link_ptr[b, -1])), F32)
        own = flow_entries[b] >= 0
        entry[flow_entries[b][own]] = np.broadcast_to(rate[:, None],
                                                      (N, K))[own]
        r = 0
        while True:
            # (a) per link: lanes sum their entries in list order, float64,
            # then the xor tree; counts in int
            v = entry[np.where(live, slots, 0)]
            fz = live & ~np.signbit(v)
            add = np.where(fz, v.astype(np.float64), 0.0)
            n = (live & np.signbit(v)).sum((1, 2))
            used = np.zeros((L, G))
            for m in range(M):
                nxt = used + add[:, m]
                assert not _two_sum_error(nxt, used, add[:, m]).any()
                used = nxt
            for off in 2 ** np.arange(int(np.log2(G)))[::-1]:
                nxt = used + used[:, lane_of ^ off]
                assert not _two_sum_error(nxt, used,
                                          used[:, lane_of ^ off]).any()
                used = nxt
            used = used[:, 0]
            if sums is not None:
                sums.append((add, used))
            avail = np.maximum(cap[b] - used.astype(F32), F32(0))
            with np.errstate(divide="ignore", invalid="ignore"):
                share = np.where(n > 0, avail / n.astype(F32),
                                 F32(ref.BIG)).astype(F32)
            # (c) per unfrozen flow: its bottleneck share over its links
            # (index -1: no link, INF); (d) theta, a frozen flow as BIG;
            # the count of unfrozen flows
            unf = np.signbit(rate)
            ext = np.append(share, F32(ref.INF))
            fshare = ext[flow_links[b]].min(1, initial=F32(ref.INF))
            theta = np.where(unf, fshare, F32(ref.BIG)).min(initial=np.inf)
            left = int(unf.sum())
            if left == 0 or r == max_rounds:
                break
            r += 1
            # (e) the tie test in float32, the freeze in both copies
            newly = unf & (fshare <= theta * tie)
            rate = np.where(newly, fshare, rate)
            hit = newly[:, None] & own
            entry[flow_entries[b][hit]] = np.broadcast_to(
                fshare[:, None], (N, K))[hit]
        out[b] = np.where(active[b] & ~np.signbit(rate), rate, F32(0))
        rounds[b], capped[b] = r, left > 0
    return out, rounds, capped


def _event_states(args, num_events=None):
    """The (B, N) active sets the water-filling of each event sees, from a
    recording run of the event loop."""
    _, log = tff._event_scan_core(*args, num_events=num_events, record=True)
    fid, is_arr = log["fid"].numpy(), log["is_arrival"].numpy()
    B, E = fid.shape
    active = np.zeros((B, args[0].shape[1]), bool)
    states = []
    for e in range(E):
        states.append(active.copy())
        active[np.arange(B), fid[:, e]] = is_arr[:, e]
    return states, log


def _check_states(args, states, log, events, fsum_every=None):
    cap = args[1]
    a = layout.dense_incidence(args[0], cap.shape[1])
    a64 = a.double()
    lists = layout.incidence_lists(a)
    for e in events:
        act = states[e]
        sums = [] if fsum_every and e % fsum_every == 0 else None
        got = emulate(lists, cap.numpy(), act, sums=sums)
        want = ref.waterfill_event_ref(a64, cap, torch.from_numpy(act))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=f"event {e}")
        np.testing.assert_array_equal(got[1], log["rounds"][:, e].numpy())
        for add, used in sums or ():
            for l in range(add.shape[0]):
                assert used[l] == math.fsum(add[l].ravel())


def test_emulation_equals_ref_on_the_states_of_a_2000_flow_run():
    """The first 300 events, and 60 from event 1740 on, where the 32-round
    cap starts to bind on this scenario (28% of its 4000 events)."""
    sc = sample_scenario(1)
    args = tff._to_device([tff._pack(sc.topo, sc.generate())], "cpu")
    states, log = _event_states(args, num_events=1800)
    late = range(1740, 1800)
    assert not log["capped"][0, :300].any() and log["capped"][0, late].any()
    _check_states(args, states, log, [*range(300), *late], fsum_every=10)


def test_emulation_equals_ref_on_a_padded_batch():
    scs = [sample_scenario(s, num_flows=n) for s, n in ((0, 40), (5, 25),
                                                        (2, 12), (9, 33))]
    assert len({sc.topo.num_links for sc in scs}) > 1
    packed = [tff._pack(sc.topo, sc.generate(), n_total=40,
                        l_total=max(sc.topo.num_links for sc in scs))
              for sc in scs]
    args = tff._to_device(packed, "cpu")
    states, log = _event_states(args)
    # padded flows become active once a short scenario's events run out
    assert any(st[2, 12:].any() for st in states)
    _check_states(args, states, log, range(len(states)), fsum_every=1)


def test_emulation_equals_ref_where_the_cap_binds_and_on_ties():
    """40 flows each alone on a link (one freezes per round: capped), and
    flows sharing links with equal capacities (ties freeze together)."""
    n = 40
    a = np.eye(n, dtype=np.float32)[None]
    cap = np.linspace(1e9, 10e9, n).astype(np.float32)[None, ::-1].copy()
    tie = np.zeros((1, n, 8), np.float32)
    tie[0, np.arange(n), np.arange(n) % 8] = 1.0
    tie[0, :5, 7] = 1.0
    for inc, c in ((a, cap), (tie, np.full((1, 8), 4e9, np.float32))):
        act = np.ones((1, n), bool)
        act[0, 3] = False
        lists = layout.incidence_lists(torch.from_numpy(inc))
        got = emulate(lists, c, act)
        want = ref.waterfill_event_ref(torch.from_numpy(inc),
                                       torch.from_numpy(c),
                                       torch.from_numpy(act))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())
    assert got[1][0] < ref.MAX_ROUNDS


def test_dispatch_routes_cpu_tensors_to_the_plain_version():
    sc = sample_scenario(3, num_flows=30)
    links, cap, *_ = tff._to_device([tff._pack(sc.topo, sc.generate())],
                                    "cpu")
    a = layout.dense_incidence(links, cap.shape[1])
    act = torch.from_numpy(np.random.default_rng(0).random((1, 30)) < 0.6)
    incidence = dispatch.waterfill_incidence(links, cap.shape[1])
    assert incidence.dtype == torch.float64 and torch.equal(incidence, a)
    got = dispatch.waterfill_event(incidence, cap, act,
                                   max_rounds=ref.MAX_ROUNDS)
    want = ref.waterfill_event_ref(a, cap, act)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.bool
