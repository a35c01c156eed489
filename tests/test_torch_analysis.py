"""repro_torch.analysis, the port's lint: the gate over `src/repro_torch`,
each checker on a known-bad and a known-good snippet (in the shape of
tests/test_analysis.py), captured bodies followed across modules, inline
suppression, the baseline's unjustified and stale entries, and a copy of
the port with an `.item()` inserted into a captured body failing the
gate."""
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from repro_torch.analysis import (DEFAULT_BASELINE, REPO_ROOT,
                                  analyze_paths, analyze_source,
                                  load_baseline, partition, save_baseline,
                                  unjustified)
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.checkers import default_checkers

CORE = "src/repro_torch/core/fixture.py"     # inside the hot/arena prefixes
COLD = "src/repro_torch/report/fixture.py"   # outside them
BASELINE = os.path.join(REPO_ROOT, DEFAULT_BASELINE)


def names(findings, checker=None):
    return [f.checker for f in findings
            if checker is None or f.checker == checker]


def src(code):
    return textwrap.dedent(code)


def test_five_checkers():
    assert [c.name for c in default_checkers()] == [
        "host-sync", "capture-safety", "dtype-drift",
        "fingerprint-coverage", "retrace-hazard"]


# ------------------------------------------------------------------ the gate
def test_cli_check_exits_0_on_the_port():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--check"], cwd=REPO_ROOT, env=env,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 new" in out.stdout and "0 unjustified" in out.stdout


def test_port_is_clean_against_committed_baseline():
    findings = analyze_paths()
    baseline = load_baseline(BASELINE)
    new, known, stale = partition(findings, baseline)
    assert not new, "\n".join(f.render() for f in new)
    assert not stale and not unjustified(baseline)
    # the two fields JAX's lint finds in the port, with JAX's reasons
    fields = sorted(f.source.split(":")[0] for f in known
                    if f.checker == "fingerprint-coverage")
    assert fields == ["probes", "record_events"]


# ----------------------------------------------------------------- host-sync
PROGRAM = src("""
    import torch
    from repro_torch.core import compiled

    def make(state, counts):
        def event():
            t = state["t"].min()
            state["t"].add_(1.0)
            return t
        return compiled.Program(load=lambda: None, event=event,
                                result=lambda: (state["t"].clone(),),
                                length=4, buffers=[state["t"]])
""")


def test_host_sync_in_a_captured_body_anywhere():
    bad = PROGRAM.replace('t = state["t"].min()',
                          't = state["t"].min()\n        t.item()')
    assert names(analyze_source(bad, COLD), "host-sync") == ["host-sync"]
    assert not names(analyze_source(PROGRAM, COLD), "host-sync")


def test_host_sync_hot_path_reads_and_host_sizes():
    bad = src("""
        def finish(out, rows):
            fct = out.cpu().numpy()         # one read, not two
            return fct, float(rows.sum()), int(rows[0])
    """)
    good = src("""
        def finish(out, rows):
            return out, int(rows.shape[0]), int(rows.size(1)), len(rows)
    """)
    found = analyze_source(bad, CORE)
    assert sorted(f.message.split(" ")[0] for f in found) == \
        ["`.cpu()`", "`float(...)`", "`int(...)`"]
    assert not analyze_source(bad, COLD)        # outside the hot packages
    assert not analyze_source(good, CORE)


def test_captured_bodies_are_followed_across_modules(tmp_path):
    """A factory's step in one module, called from a program's event in
    another, through a module alias and a parameter: the `.item()` in the
    factory's nested function is inside a captured body."""
    pkg = tmp_path / "src" / "repro_torch" / "report"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "steps.py").write_text(src("""
        def make_step(scale):
            def step(x):
                return x * scale + x.max().item()
            return step
    """))
    (pkg / "loop.py").write_text(src("""
        from repro_torch.core import compiled
        from . import steps

        def body(step, x):
            return step(x)

        def program(x):
            step = steps.make_step(2.0)

            def event():
                return body(step, x)
            return compiled.Program(load=None, event=event, result=None,
                                    length=1)
    """))
    found = analyze_paths(["src/repro_torch/report"], root=str(tmp_path))
    assert [(f.checker, f.path.rsplit("/", 1)[1]) for f in found] == \
        [("host-sync", "steps.py")]
    # the same factory, never captured, is clean outside the hot packages
    (pkg / "loop.py").write_text("from . import steps\n")
    assert not analyze_paths(["src/repro_torch/report"], root=str(tmp_path))


# ------------------------------------------------------------ capture-safety
SCHEDULE = src("""
    import torch
    from repro_torch.core import compiled

    def make_schedule(lr: float):
        return lambda step: torch.tensor(lr)

    def make_step(schedule):
        def body():
            buf["lr"].copy_(schedule(buf["step"]))
        return compiled.StepProgram(load=None, body=body, result=None,
                                    replays=1)

    def fit(lr: float):
        return make_step(make_schedule(lr))
""")


def test_capture_safety_const_schedule_pair():
    """The `const` schedule: a host tensor of lr inside the captured
    update is refused by a capture; a fill on the device is not."""
    found = analyze_source(SCHEDULE, COLD)
    assert names(found) == ["capture-safety"]
    assert "torch.tensor" in found[0].message
    good = SCHEDULE.replace("torch.tensor(lr)",
                            "torch.full_like(step, lr, dtype=torch.float32)")
    assert not analyze_source(good, COLD)


def test_capture_safety_indexed_write_of_a_host_scalar():
    bad = src("""
        import torch
        from repro_torch.core import compiled

        def make(state, idx, lr: float):
            def event():
                state["done"][idx] = True
                state["rate"][idx] = lr
                state["t"][0] += 0.5
                return state["t"]
            return compiled.Program(load=None, event=event, result=None,
                                    length=1)
    """)
    good = bad.replace("= True", "= torch.ones_like(idx, dtype=torch.bool)") \
        .replace("= lr", "= state[\"lr\"]").replace("+= 0.5",
                                                    "+= state[\"dt\"]")
    assert names(analyze_source(bad, COLD)) == ["capture-safety"] * 3
    assert not analyze_source(good, COLD)
    # the same writes outside a captured body are fine (eager loads)
    assert not analyze_source(bad.replace("event=event", "load=event"),
                              COLD)


# --------------------------------------------------------------- dtype-drift
def test_dtype_drift_scoped_to_arena_and_training_code():
    bad = src("""
        import numpy as np
        import torch

        def arenas(B, N, dev):
            a = torch.zeros(B, N, device=dev)
            b = torch.arange(B, device=dev)
            c = np.full(N, 8.0)
            return a, b, c
    """)
    good = src("""
        import numpy as np
        import torch

        def arenas(B, N, dev):
            f32 = {"dtype": torch.float32, "device": dev}
            a = torch.zeros(B, N, dtype=torch.float32, device=dev)
            b = torch.arange(B, dtype=torch.long, device=dev)
            c = np.full(N, 8.0, np.float64)
            return a, b, c, torch.empty(B, **f32), torch.zeros_like(a)
    """)
    assert names(analyze_source(bad, CORE)) == ["dtype-drift"] * 3
    assert names(analyze_source(bad, "src/repro_torch/train/x.py")) == \
        ["dtype-drift"] * 3
    assert not analyze_source(bad, COLD)
    assert not analyze_source(good, CORE)


# ------------------------------------------------------ fingerprint-coverage
FP_FIXTURE = src("""
    from dataclasses import dataclass

    @dataclass(frozen=True)
    class SimRequest:
        seed: int = 0
        record_events: bool = False

        def content_hash(self):
            return str(self.seed)           # record_events not reflected
""")


def test_fingerprint_coverage_flags_missing_field():
    found = analyze_source(FP_FIXTURE, "src/repro_torch/sim/fixture.py")
    assert [f.source.split(":")[0].strip() for f in found] == \
        ["record_events"]
    covered = FP_FIXTURE.replace("str(self.seed)",
                                 "str((self.seed, self.record_events))")
    wholesale = FP_FIXTURE.replace("str(self.seed)", "repr(request)")
    assert not analyze_source(covered, "src/repro_torch/sim/fixture.py")
    assert not analyze_source(wholesale, "src/repro_torch/sim/fixture.py")


# ------------------------------------------------------------ retrace-hazard
def test_retrace_graph_or_cache_made_in_a_loop():
    bad = src("""
        import torch
        from repro_torch.core import compiled

        def capture(steps, counts):
            for step in steps:
                graph = torch.cuda.CUDAGraph()
                cache = compiled.StepCache(counts, "s")
            while steps:
                compiled.run(counts, "e", (1,), "cuda", steps.pop)

            def later():
                return torch.cuda.CUDAGraph()    # defined, not run, per turn
            return graph, cache, later
    """)
    good = src("""
        import torch

        def capture(steps):
            graph = torch.cuda.CUDAGraph()
            for step in steps:
                step()
            return graph
    """)
    found = analyze_source(bad, COLD)
    assert names(found) == ["retrace-hazard"] * 3
    assert not analyze_source(good, COLD)


SIMULATE = os.path.join(REPO_ROOT, "src", "repro_torch", "core",
                        "simulate.py")
KEY = "key = (cfg, num_links, B, N, K, snapshot_impl, num_events, probes)"


def test_retrace_key_without_num_events():
    """Dropping `num_events` from the open loop's key: the program's length
    (2N or num_events) would no longer key its entry."""
    with open(SIMULATE) as f:
        text = f.read()
    assert text.count(KEY) == 1
    path = "src/repro_torch/core/simulate.py"
    assert not names(analyze_source(text, path), "retrace-hazard")
    found = names(analyze_source(text.replace(", num_events, probes)",
                                              ", probes)"), path),
                  "retrace-hazard")
    assert found == ["retrace-hazard"]
    msg = [f.message for f in analyze_source(
        text.replace(", num_events, probes)", ", probes)"), path)
        if f.checker == "retrace-hazard"][0]
    assert "num_events (through length)" in msg
    assert names(analyze_source(text.replace(", num_events, probes)",
                                             ", num_events)"), path),
                 "retrace-hazard") == ["retrace-hazard"]


def test_retrace_key_of_a_plain_name_argument():
    bad = src("""
        from repro_torch.core import compiled

        def core(x, scale: float, counts):
            def build(x, scale):
                return make(x, scale)
            return compiled.run(counts, "e", (x.shape[0],), x.device, build,
                                x, scale)
    """)
    good = bad.replace("(x.shape[0],)", "(x.shape[0], scale)")
    assert names(analyze_source(bad, COLD)) == ["retrace-hazard"]
    assert not analyze_source(good, COLD)


# ---------------------------------------------------- suppression + baseline
def test_pragma_suppresses_on_line_and_above():
    bad = src("""
        def finish(out):
            return out.cpu()
    """)
    same = bad.replace("out.cpu()",
                       "out.cpu()  # lint-torch: disable=host-sync")
    above = bad.replace("    return out.cpu()",
                        "    # lint-torch: disable=host-sync\n"
                        "    return out.cpu()")
    other = bad.replace("out.cpu()",
                        "out.cpu()  # lint-torch: disable=dtype-drift")
    jax_pragma = bad.replace("out.cpu()",
                             "out.cpu()  # lint-jax: disable=host-sync")
    assert names(analyze_source(bad, CORE)) == ["host-sync"]
    assert not analyze_source(same, CORE)
    assert not analyze_source(above, CORE)
    assert names(analyze_source(other, CORE)) == ["host-sync"]
    assert names(analyze_source(jax_pragma, CORE)) == ["host-sync"]


def test_baseline_roundtrip_and_line_moves(tmp_path):
    bad = src("""
        def finish(out):
            return out.cpu(), out.tolist()
    """)
    findings = analyze_source(bad, CORE)
    assert len(findings) == 2
    path = str(tmp_path / "baseline.json")
    save_baseline(path, findings)
    baseline = load_baseline(path)
    new, known, stale = partition(findings, baseline)
    assert not new and len(known) == 2 and not stale
    assert len(unjustified(baseline)) == 2          # TODO markers
    moved = analyze_source("# a leading comment\n" + bad, CORE)
    assert [f.fingerprint for f in moved] == [f.fingerprint for f in findings]
    assert [f.line for f in moved] != [f.line for f in findings]


def _write_tree(tmp_path, text):
    (tmp_path / "src" / "repro_torch" / "core").mkdir(parents=True)
    (tmp_path / "src" / "repro_torch" / "core" / "x.py").write_text(text)


def test_cli_unjustified_entry_fails_and_stale_entry_does_not(tmp_path,
                                                              capsys):
    bad = src("""
        def finish(out):
            return out.cpu()
    """)
    _write_tree(tmp_path, bad)
    bl = str(tmp_path / "bl.json")
    args = ["--root", str(tmp_path), "--baseline", bl, "--check"]
    assert cli_main(args) == 1                      # a new finding
    assert cli_main(["--root", str(tmp_path), "--baseline", bl,
                     "--update-baseline"]) == 0
    assert cli_main(args) == 1                      # entry still TODO
    assert "UNJUSTIFIED" in capsys.readouterr().out
    data = json.load(open(bl))
    data["entries"][0]["justification"] = "read once, after the loop"
    data["entries"].append(dict(data["entries"][0], fingerprint="0" * 16,
                                source="gone()"))
    json.dump(data, open(bl, "w"))
    assert cli_main(args) == 0                      # stale: reported only
    out = capsys.readouterr().out
    assert "STALE baseline entry 0000000000000000" in out
    assert "1 stale" in out


def _copy_port(tmp_path):
    dst = tmp_path / "src" / "repro_torch"
    shutil.copytree(os.path.join(REPO_ROOT, "src", "repro_torch"), dst,
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    return dst


@pytest.mark.parametrize("where", [
    ("core/flowsim_fast.py",
     "        rates, rounds, capped = dispatch.waterfill_event(\n"
     "            inc, cap, active, max_rounds=MAX_ROUNDS)\n",
     "        rounds.max().item()\n"),
    ("core/simulate.py",
     "    state, _, snap = step(params, state, t_ev, fid, is_arr)\n",
     "    float(t_ev[0])\n"),
    ("train/loop.py",
     "        new_p, new_o, row = update(p_buf, o_buf, b)\n",
     "        row.tolist()\n"),
    # the sharded batch step: a shard's sums (through the closure it is
    # handed) and the update that sums the shards
    ("train/loop.py",
     "    def local_sums(params, bb, w):\n",
     "        w.sum().item()\n"),
    ("train/loop.py",
     "            total = s_buf.sum(0)\n",
     "            float(total[4])\n"),
])
def test_item_inserted_into_a_captured_body_fails_the_gate(tmp_path, where):
    rel, anchor, inserted = where
    port = _copy_port(tmp_path)
    path = port / rel
    text = path.read_text()
    assert text.count(anchor) == 1
    path.write_text(text.replace(anchor, anchor + inserted))
    args = ["--root", str(tmp_path), "--baseline", BASELINE, "--check",
            "--json", str(tmp_path / "report.json")]
    assert cli_main(args) == 1
    report = json.load(open(tmp_path / "report.json"))
    new = [f for f in report["findings"] if f["fingerprint"] in report["new"]]
    assert [(f["checker"], f["path"], f["source"]) for f in new] == \
        [("host-sync", f"src/repro_torch/{rel}", inserted.strip())]
    assert "captured body" in new[0]["message"]
    path.write_text(text)
    assert cli_main(args) == 0
