"""Import hygiene of the PyTorch port: `repro_torch` and `chip_smoke.py`
import neither `jax` nor anything of the JAX package `repro`, nor
`msgpack` or `zstandard`, which the machine with the card lacks (the
port's checkpoints and blob store use its own codec, zlib and its own
zstd decoder). The sweep engine, the training pipeline, the probes, the
obs layer with its divergence observatory, the compiled event loops,
the simulation service, the fleet with its resilience policies, and the
CLIs' modules are among those imported. That a spawned fleet worker
imports neither is checked in tests/test_torch_fleet_spawn.py."""
import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")

MODULES = ["repro_torch", "repro_torch.sim", "repro_torch.sim.closedloop",
           "repro_torch.core.simulate", "repro_torch.core.model",
           "repro_torch.core.flowsim", "repro_torch.core.flowsim_fast",
           "repro_torch.core.closedloop", "repro_torch.kernels.dispatch",
           "repro_torch.kernels.build", "repro_torch.kernels.fused_gru.ops",
           "repro_torch.kernels.bipartite.ops",
           "repro_torch.kernels.waterfill.ops",
           "repro_torch.kernels.waterfill.ref", "repro_torch.weights",
           "repro_torch.data.traffic", "repro_torch.net",
           "repro_torch.net.packetsim", "repro_torch.core.events",
           "repro_torch.core.training", "repro_torch.runtime.codec",
           "repro_torch.runtime.blobstore", "repro_torch.runtime.checkpoint",
           "repro_torch.runtime.guards", "repro_torch.optim",
           "repro_torch.optim.adamw", "repro_torch.optim.schedules",
           "repro_torch.train", "repro_torch.train.batching",
           "repro_torch.train.data", "repro_torch.train.loop",
           "repro_torch.train.prng", "repro_torch.train.__main__",
           "repro_torch.runtime.zstd", "repro_torch.scenarios",
           "repro_torch.scenarios.spec", "repro_torch.scenarios.suites",
           "repro_torch.scenarios.cache", "repro_torch.scenarios.runner",
           "repro_torch.scenarios.__main__", "repro_torch.core.probes",
           "repro_torch.obs", "repro_torch.obs.registry",
           "repro_torch.obs.trace", "repro_torch.obs.export",
           "repro_torch.obs.timeseries", "repro_torch.obs.torchprof",
           "repro_torch.obs.diff", "repro_torch.obs.__main__",
           "repro_torch.core.compiled", "repro_torch.serve",
           "repro_torch.serve.clock", "repro_torch.serve.metrics",
           "repro_torch.serve.service", "repro_torch.serve.http",
           "repro_torch.serve.__main__", "repro_torch.runtime.resilience",
           "repro_torch.fleet", "repro_torch.fleet.coord",
           "repro_torch.fleet.chaos", "repro_torch.fleet.metrics",
           "repro_torch.fleet.jobs", "repro_torch.fleet.worker",
           "repro_torch.fleet.supervisor", "repro_torch.fleet.__main__"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "msgpack", "zstandard")


def test_import_pulls_in_no_jax_and_no_repro():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print('\\n'.join(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout.split()
    assert set(MODULES) <= set(out)
    assert [m for m in out if _forbidden(m)] == []


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_ast_scan_finds_no_jax_or_repro_import():
    bad = []
    files = _port_sources()
    assert len(files) > 10
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert bad == []
