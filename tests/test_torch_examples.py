"""The port's three examples (examples/*_torch.py) against the JAX
package's, on the CPU (`--device cpu`):

- `ring_flows` equal to JAX's, field for field;
- simulate_collectives_torch.py against simulate_collectives.py on one
  dry-run record the port wrote (moonshot-v1-16b-a3b's train cell at
  `reduce_for_smoke` on a (2, 2) mesh): the printed kinds, bytes,
  alpha-beta and flowSim columns equal, the flowSim times bitwise, m4's
  within rtol 1e-5 plus one float32 ulp of the completion time;
- closed_loop_torch.py against closed_loop.py at `--racks 4
  --flows-per-rack 6 --limits 1 3`: the packet DES's and flowSim's
  throughputs bitwise, m4's within rtol 1e-5;
- quickstart_torch.py at `--flows 40 --sims 2 --epochs 2` runs to its end
  with finite errors.

Both sides of a comparison run one m4: a JAX `init_m4` tree at a small
width, carried over by `params_from_jax`, given to each example through
its trained-model hook (`trained_m4`, monkeypatched), so nothing trains.
"""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")

from repro.core import model as jm  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.net.topology import FatTree as JaxFatTree  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.model import M4Config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (init_fake_group,  # noqa: E402
                                     make_debug_mesh)
from repro_torch.net import FatTree  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FCT_RTOL = 1e-5
GATE = dict(hidden=16, gnn_dim=16, mlp_hidden=16, gnn_layers=2,
            snap_flows=16, snap_links=32)
FLOW_FIELDS = ("fid", "src", "dst", "size", "t_arrival", "path")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def models():
    jcfg = jsim.canonicalize_cfg(jm.M4Config(**GATE))
    jp = jm.init_m4(jax.random.PRNGKey(0), jcfg)
    return (jp, jcfg), (params_from_jax(jax.device_get(jp), "cpu"),
                        M4Config(**GATE))


def _hook(monkeypatch, mod, model):
    monkeypatch.setattr(mod, "trained_m4", lambda *a, **kw: model)


def _spy(monkeypatch, mod, name, seen):
    """Record what each call of `mod.<name>` returns, in `seen`."""
    inner = getattr(mod, name)

    def spied(*a, **kw):
        out = inner(*a, **kw)
        seen.append(out)
        return out
    monkeypatch.setattr(mod, name, spied)


def _run_jax(monkeypatch, mod, argv):
    monkeypatch.setattr(sys, "argv", [mod.__file__] + argv)
    mod.main()


def test_ring_flows_equal_jax():
    ours = _example("simulate_collectives_torch")
    theirs = _example("simulate_collectives")
    for ranks, nbytes in ((16, 3.75e8), (8, 123.0), (5, 1e6)):
        got = ours.ring_flows(FatTree(8, 4, 4, link_gbps=100.0), ranks,
                              nbytes)
        want = theirs.ring_flows(JaxFatTree(8, 4, 4, link_gbps=100.0),
                                 ranks, nbytes)
        assert [[getattr(f, k) for k in FLOW_FIELDS] for f in got] == \
            [[getattr(f, k) for k in FLOW_FIELDS] for f in want]


def _lines(text):
    """The example's per-collective lines, split into their columns."""
    return [ln.split(", ") for ln in text.splitlines()
            if ln.count(", ") == 4 and not ln.startswith("collective")]


def test_simulate_collectives_matches_jax(tmp_path, monkeypatch, capsys,
                                          models):
    init_fake_group()
    cfg = configs.reduce_for_smoke(configs.get_config("moonshot-v1-16b-a3b"))
    rec = dryrun.lower_cell("moonshot-v1-16b-a3b", "train_4k", False,
                            verbose=False, cfg=cfg, mesh=make_debug_mesh(2, 2))
    cell = tmp_path / "moonshot-v1-16b-a3b_train_4k_2x2.json"
    cell.write_text(json.dumps(rec))
    argv = ["--cell", str(cell), "--ranks", "16"]
    (jp, jcfg), (tp, tcfg) = models

    theirs = _example("simulate_collectives")
    _hook(monkeypatch, theirs, (jp, jcfg))
    runs = []

    def backend(*a, **kw):
        b = jax_get_backend(*a, **kw)
        _spy(monkeypatch, b, "run", runs)
        return b
    jax_get_backend = theirs.get_backend
    monkeypatch.setattr(theirs, "get_backend", backend)
    _run_jax(monkeypatch, theirs, argv)
    want_text = capsys.readouterr().out

    ours = _example("simulate_collectives_torch")
    _hook(monkeypatch, ours, (tp, tcfg))
    rows = ours.main(argv + ["--device", "cpu"])
    got_text = capsys.readouterr().out

    assert [r[0] for r in rows] == list(rec["collective_kinds"])
    assert len(runs) == 2 * len(rows)
    for (kind, nbytes, t_ab, t_fs, t_m4), fs, m4 in zip(rows, runs[0::2],
                                                        runs[1::2]):
        assert t_fs == np.nanmax(fs.fcts)
        want = np.nanmax(m4.fcts)
        assert np.isfinite(t_m4) and t_m4 > 0
        assert abs(t_m4 - want) <= FCT_RTOL * abs(want) + float(
            np.spacing(np.float32(want))), (kind, t_m4, want)
    got, want = _lines(got_text), _lines(want_text)
    assert len(got) == len(rows) and [r[:4] for r in got] == \
        [r[:4] for r in want]


def test_closed_loop_matches_jax(monkeypatch, capsys, models):
    argv = ["--racks", "4", "--flows-per-rack", "6", "--limits", "1", "3"]
    (jp, jcfg), (tp, tcfg) = models
    seen = {}
    for name, model, run in (
            ("closed_loop", (jp, jcfg), None),
            ("closed_loop_torch", (tp, tcfg), argv + ["--device", "cpu"])):
        mod = _example(name)
        _hook(monkeypatch, mod, model)
        seen[name] = []
        _spy(monkeypatch, mod, "run_closed_loop", seen[name])
        if run is None:
            _run_jax(monkeypatch, mod, argv)
        else:
            rows = mod.main(run)
    capsys.readouterr()
    want, got = seen["closed_loop"], seen["closed_loop_torch"]
    assert len(got) == len(want) == 6        # 3 backends x 2 limits
    assert [r[0] for r in rows] == [1, 3]
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.isfinite(g.throughput) and g.throughput > 0
        if i % 3 < 2:                        # packet, flowsim
            assert g.throughput == w.throughput
            np.testing.assert_array_equal(g.completion_times,
                                          w.completion_times)
        else:                                # m4
            np.testing.assert_allclose(g.throughput, w.throughput,
                                       rtol=FCT_RTOL)


def test_quickstart_runs_to_its_end(tmp_path, capsys):
    ev = _example("quickstart_torch").main(
        ["--flows", "40", "--sims", "2", "--epochs", "2", "--device", "cpu",
         "--workdir", str(tmp_path)])
    assert np.isfinite(ev["m4_err_mean"]) and np.isfinite(
        ev["flowsim_err_mean"])
    assert "m4 reduces mean error" in capsys.readouterr().out
