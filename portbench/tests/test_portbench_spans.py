"""The readers of the port's own spans (`prep_ms`, `upload_ms`,
`results_ms`, through `portbench/harness/spans.py`): on a hand-built
trace, each span's self time (its duration less the program's spans
inside it, torch operations not subtracted), summed over the spans that
start inside a call and averaged over the traced calls, exactly; on a
CPU traced run of each lane, read from the profiler's own records; and
the breakdown names an idle gap after the program's span it fell in."""
import dataclasses

import numpy as np
import pytest

from portbench.harness import lanes, runner, spans, spec
from portbench.harness import trace as tracing
from portbench.harness.runner import Call, Run
from portbench.harness.trace import CALL_SPAN, Trace
from portbench.tests.conftest import small_cell

MS = 1_000_000          # nanoseconds


def _run(host, traced=True):
    calls = [(0, 1000 * MS), (1200 * MS, 2000 * MS)]
    tr = Trace(window=(0, 2000 * MS), calls=calls, dev_names=[],
               dev_op=np.zeros(0, np.int64),
               dev_start=np.zeros(0, np.int64),
               dev_end=np.zeros(0, np.int64),
               host=[(s, e, CALL_SPAN) for s, e in calls] + host)
    return Run(cell=None, setup_s=1.0,
               calls=[Call(0, 0.0, 1.0, 16000, 8), Call(1, 1.2, 2.0, 16000, 8)],
               batch=8, num_flows=2000, num_links={}, nnz={}, counts={},
               trace=tr if traced else None,
               traced_calls=[Call(0, 0.0, 1.0, 16000, 8),
                             Call(1, 1.2, 2.0, 16000, 8)] if traced else [])


HOST = [
    (1 * MS, 999 * MS, "sim.run_many"),
    # 100 ms, of which nested program spans cover 20 + 20 (a span and its
    # child count once); a torch operation inside is the span's own time
    (2 * MS, 102 * MS, "sim.prep"),
    (10 * MS, 30 * MS, "compiled.load"),
    (50 * MS, 70 * MS, "compiled.run"),
    (55 * MS, 65 * MS, "compiled.replay"),
    (80 * MS, 90 * MS, "aten::copy_"),
    (102 * MS, 302 * MS, "sim.upload"),
    (1201 * MS, 1999 * MS, "sim.run_many"),
    (1210 * MS, 1250 * MS, "sim.prep"),
    # starts before the window's calls: not read
    (-50 * MS, -10 * MS, "sim.prep"),
]


def _read(name, run):
    return spec.reader(name).read(run)


def test_self_time_averaged_over_the_traced_calls_exactly():
    run = _run(HOST)
    assert _read("prep_ms.m4", run) == pytest.approx((60.0 + 40.0) / 2)
    assert _read("prep_ms.flowsim", run) == pytest.approx(50.0)
    assert _read("upload_ms.flowsim", run) == pytest.approx(200.0 / 2)
    # no such span ran: a float, 0
    v = _read("results_ms.flowsim", run)
    assert isinstance(v, float) and v == 0.0


def test_readers_read_nothing_without_a_trace_or_the_programs_spans(
        monkeypatch):
    for name in ("prep_ms.m4", "upload_ms.flowsim", "results_ms.flowsim"):
        assert _read(name, _run(HOST, traced=False)) is None
    monkeypatch.setattr(spans, "program_has_spans", lambda: False)
    for name in ("prep_ms.m4", "upload_ms.flowsim", "results_ms.flowsim"):
        assert _read(name, _run(HOST)) is None


def test_host_label_names_the_innermost_program_span():
    tr = _run(HOST).trace
    assert tr.host_label(5 * MS) == f"{CALL_SPAN}: sim.prep"
    assert tr.host_label(60 * MS) == f"{CALL_SPAN}: compiled.replay"
    assert tr.host_label(500 * MS) == f"{CALL_SPAN}: sim.run_many"
    assert tr.host_label(1100 * MS) == "between calls"


def _idle_only_in(tr: Trace, pieces) -> Trace:
    """`tr` with device operations over its whole window except
    `pieces`, so that its idle gaps are exactly those."""
    lo, hi = tr.window
    starts = [lo] + [e for _, e in pieces]
    ends = [s for s, _ in pieces] + [hi]
    keep = [(s, e) for s, e in zip(starts, ends) if e > s]
    return dataclasses.replace(
        tr, dev_names=["busy"], dev_op=np.zeros(len(keep), np.int64),
        dev_start=np.array([s for s, _ in keep], np.int64),
        dev_end=np.array([e for _, e in keep], np.int64))


@pytest.mark.parametrize("name, metrics", [
    ("ft8-table2.m4-b8", ["prep_ms.m4"]),
    ("meta-fabric.flowsim-b8", ["prep_ms.flowsim", "upload_ms.flowsim",
                                "results_ms.flowsim"]),
])
def test_traced_cpu_run_reads_the_programs_spans(name, metrics,
                                                 monkeypatch):
    """A traced run on the CPU's plain paths: the port's spans are on
    the profiler's timeline, one `sim.prep` in each traced call, and the
    new metrics read them; where the device idles exactly while the port
    prepares, the breakdown names each gap after `sim.prep`."""
    seen = []
    reduce = tracing.Profiler.trace

    def keep(self):
        seen.append(reduce(self))
        return seen[-1]
    monkeypatch.setattr(tracing.Profiler, "trace", keep)
    cell = small_cell(name, trace=True, flows=30, batch=2)
    result, checks = runner.execute(cell, 2 ** 31 + 7, 0.0, True, 0.0,
                                    log=lambda s: None, device="cpu")
    assert result["correct"], checks
    for m in metrics:
        assert result["metrics"][m]["value"] > 0, m
    tr, = seen
    inside = [(s, e) for s, e, n in tr.host if n == "sim.prep"
              and any(c0 <= s <= c1 for c0, c1 in tr.calls)]
    assert len(inside) == len(tr.calls) == lanes.Lane.traced_passes * \
        cell.traffic["pool"]
    for s, e, n in tr.host:
        if n in ("sim.prep", "sim.upload", "sim.results", "compiled.run"):
            root = [r for r in tr.host if r[2] == "sim.run_many"
                    and r[0] <= s and e <= r[1]]
            assert len(root) == 1, n
    gaps = runner.breakdown(_idle_only_in(tr, sorted(inside)))["idle_gaps"]
    assert len(gaps) == len(inside)
    assert {label for label, _ in gaps} == {f"{CALL_SPAN}: sim.prep"}
