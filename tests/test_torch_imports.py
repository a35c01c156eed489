"""Import hygiene of the PyTorch port: `repro_torch`, `chip_smoke.py` and
the port's examples (`examples/*_torch.py`, scanned as source) import
neither `jax` nor anything of the JAX package `repro` or of
`benchmarks/`, nor `msgpack` or `zstandard`, which the machine with the
card lacks (the
port's checkpoints and blob store use its own codec, zlib and its own
zstd decoder). The sweep engine, the training pipeline, the probes, the
obs layer with its divergence observatory, the compiled event loops,
the simulation service, the fleet with its resilience policies, the
lint `repro_torch.analysis`, the multi-device sharding, the LM
substrate (`nn`, `models`, `configs` and its ten config modules) and the
CLIs' modules are among those imported; none pulls in `ml_dtypes` either (the checkpoints write
bfloat16 leaves without it). That a spawned fleet worker
imports neither is checked in tests/test_torch_fleet_spawn.py."""
import ast
import glob
import os
import subprocess
import sys

import pytest

# one torch thread: the suite's xdist workers share the host's cores
pytest.importorskip("torch").set_num_threads(1)

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
           "repro_torch.fleet.supervisor", "repro_torch.fleet.__main__",
           "repro_torch.analysis", "repro_torch.analysis.checkers",
           "repro_torch.analysis.findings", "repro_torch.analysis.baseline",
           "repro_torch.analysis.__main__", "repro_torch.core.sharding",
           "repro_torch.nn", "repro_torch.nn.layers", "repro_torch.nn.rope",
           "repro_torch.nn.attention", "repro_torch.nn.ssm",
           "repro_torch.nn.moe", "repro_torch.models",
           "repro_torch.models.arch", "repro_torch.models.lm",
           "repro_torch.configs"] + [
    f"repro_torch.configs.{a}" for a in (
        "gemma2_9b", "yi_34b", "qwen3_14b", "gemma_7b", "qwen2_vl_7b",
        "musicgen_medium", "moonshot_v1_16b_a3b", "llama4_scout_17b_a16e",
        "mamba2_1p3b", "zamba2_2p7b")]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "msgpack", "zstandard",
                   "ml_dtypes", "benchmarks")


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
    """The port, chip_smoke.py and the port's examples (examples/*_torch.py,
    their shared trained_m4_torch.py among them)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += glob.glob(os.path.join(REPO, "examples", "*_torch.py"))
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_ast_scan_finds_no_jax_or_repro_import():
    bad = []
    files = _port_sources()
    assert len(files) > 10
    assert {os.path.basename(f) for f in files} >= {
        "quickstart_torch.py", "closed_loop_torch.py",
        "simulate_collectives_torch.py", "trained_m4_torch.py",
        "train_lm_torch.py"}
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


def test_analysis_import_pulls_in_no_jax_and_no_repro():
    """The lint alone, run over the port: pure `ast`, so it imports none
    of the JAX package, not even `repro.analysis` whose framework it
    copies."""
    code = ("import sys\n"
            "import repro_torch.analysis as a\n"
            "from repro_torch.analysis.__main__ import main\n"
            "assert a.analyze_paths()\n"
            "print('\\n'.join(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout.split()
    assert "repro_torch.analysis.checkers" in out
    assert [m for m in out if _forbidden(m)] == []
