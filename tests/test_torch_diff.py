"""The port's divergence observatory against `repro.obs.diff`, on the CPU.

- `diff_sweep` over smoke16's first 4 specs at 16 flows, m4 at gate scale
  (JAX's PRNGKey(0) weights carried across by `repro_torch.weights`)
  against the packet DES, probes on: the report equals JAX's at rtol 1e-5
  (summary, profiles with their probe distances, families, clusters),
  and its worst specs are the same;
- a second call serves its FCT passes from the cache;
- `read_report` rejects a wrong schema; `worst_suite` round-trips into
  the port's `divergence_worst` suite;
- `python -m repro_torch.obs.diff --device cpu` writes a report and probe
  files that `python -m repro_torch.obs --check` passes.
"""
import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")

from repro.core import model as jm  # noqa: E402
from repro.core import simulate as jsim  # noqa: E402
from repro.core.probes import ProbeConfig as JaxProbeConfig  # noqa: E402
from repro.obs import diff as jdiff  # noqa: E402
from repro.scenarios import get_suite as jax_suite  # noqa: E402
from repro.sim import get_backend as jax_backend  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.model import M4Config  # noqa: E402
from repro_torch.core.probes import ProbeConfig  # noqa: E402
from repro_torch.obs import __main__ as obs_cli  # noqa: E402
from repro_torch.obs import diff as tdiff  # noqa: E402
from repro_torch.scenarios import get_suite  # noqa: E402
from repro_torch.sim import get_backend  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

RTOL = 1e-5
GATE = dict(hidden=16, gnn_dim=16, mlp_hidden=16, gnn_layers=2,
            snap_flows=16, snap_links=32)
PROBES = dict(stride=4, max_samples=64)


def _close(got, want, path="report"):
    """Equal structure; floats at rtol 1e-5, everything else exact."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12,
                                   err_msg=path)
    else:
        assert got == want, path


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    jcfg = jsim.canonicalize_cfg(jm.M4Config(**GATE))
    jp = jm.init_m4(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.device_get(jp), "cpu")
    root = tmp_path_factory.mktemp("diff")
    jrep = jdiff.diff_sweep(
        jax_suite("smoke16", num_flows=16).limit(4),
        jax_backend("m4", params=jp, cfg=jcfg), jax_backend("packet"),
        cache_dir=str(root / "jax_cache"),
        probes=JaxProbeConfig(**PROBES))
    backend = get_backend("m4", params=tp, cfg=M4Config(**GATE),
                          device="cpu")
    suite = get_suite("smoke16", num_flows=16).limit(4)
    kw = dict(cache_dir=str(root / "cache"), probes=ProbeConfig(**PROBES),
              probes_dir=str(root / "probes"))
    trep = tdiff.diff_sweep(suite, backend, get_backend("packet"), **kw)
    hits = 'sweep.cache_hits{backend="m4"}'
    before = obs.get_registry().snapshot()["counters"].get(hits, 0)
    again = tdiff.diff_sweep(suite, backend, get_backend("packet"), **kw)
    after = obs.get_registry().snapshot()["counters"][hits]
    return trep, jrep, again, after - before, root


def test_diff_sweep_matches_jax(reports):
    trep, jrep, *_ = reports
    assert trep["schema"] == jrep["schema"] == tdiff.SCHEMA_DIFF
    for k in ("suite", "backend", "oracle", "worst_specs"):
        assert trep[k] == jrep[k], k
    _close(trep["summary"], jrep["summary"], "summary")
    _close(trep["profiles"], jrep["profiles"], "profiles")
    _close(trep["families"], jrep["families"], "families")
    _close(trep["clusters"], jrep["clusters"], "clusters")
    assert trep["summary"]["scenarios"] == 4
    # m4 and the DES share link_active and flow_remaining
    for p in trep["profiles"]:
        assert set(p["probe_distance"]) == {"link_active", "flow_remaining"}
    # the registry snapshot carries the same metric names
    assert set(trep["obs"]["histograms"]) == set(jrep["obs"]["histograms"])
    assert set(trep["obs"]["gauges"]) == set(jrep["obs"]["gauges"])


def test_second_call_takes_fct_passes_from_the_cache(reports):
    trep, _, again, m4_hits, root = reports
    assert m4_hits == 4
    _close(again["profiles"], trep["profiles"])
    files = sorted(p.name for p in (root / "probes").iterdir())
    assert len(files) == 8 and all(f.endswith(".probes.jsonl")
                                   for f in files)
    with contextlib.redirect_stdout(io.StringIO()):
        assert obs_cli.main(["--dir", str(root / "probes"), "--check"]) == 0


def test_read_report_and_worst_suite_round_trip(reports, tmp_path):
    trep = reports[0]
    path = tdiff.write_report(trep, str(tmp_path / "report.json"))
    back = tdiff.read_report(path)
    assert back["summary"] == trep["summary"]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(dict(back, schema="repro.obs.diff/0")))
    with pytest.raises(ValueError, match="not a repro.obs.diff/1 report"):
        tdiff.read_report(str(bad))
    worst = tdiff.worst_suite(back, k=3)
    suite = get_suite("divergence_worst", report=path, k=3)
    assert worst.name == suite.name == "divergence_worst"
    assert list(worst) == list(suite)
    assert [s.label for s in worst] == \
        [p["label"] for p in back["profiles"][:3]]
    rescaled = tdiff.worst_suite(back, k=2, num_flows=9)
    assert [s.num_flows for s in rescaled] == [9, 9]
    assert list(get_suite("divergence_worst", report=path, k=2,
                          num_flows=9)) == list(rescaled)
    assert [dataclasses.replace(s, num_flows=9) for s in worst][:2] == \
        list(rescaled)


def test_diff_cli_on_the_cpu(tmp_path):
    out = tmp_path / "div" / "report.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tdiff.main(["--suite", "smoke16", "--limit", "2",
                         "--num-flows", "10", "--probes", "--device", "cpu",
                         "--cache-dir", str(tmp_path / "cache"),
                         "--out", str(out)])
    assert rc == 0 and "divergence: 2 scenarios" in buf.getvalue()
    rep = tdiff.read_report(str(out))
    assert rep["backend"] == "m4" and rep["oracle"] == "packet"
    assert len(list((tmp_path / "div").glob("*.probes.jsonl"))) == 4
    with contextlib.redirect_stdout(io.StringIO()):
        assert obs_cli.main(["--dir", str(tmp_path / "div"),
                             "--check"]) == 0
