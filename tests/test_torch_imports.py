"""Import hygiene of the PyTorch port: `repro_torch` and `chip_smoke.py`
import neither `jax` nor anything of the JAX package `repro`."""
import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")

MODULES = ["repro_torch", "repro_torch.sim", "repro_torch.core.simulate",
           "repro_torch.core.model", "repro_torch.kernels.dispatch",
           "repro_torch.kernels.build", "repro_torch.kernels.fused_gru.ops",
           "repro_torch.kernels.bipartite.ops", "repro_torch.weights",
           "repro_torch.data.traffic", "repro_torch.net"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_import_pulls_in_no_jax_and_no_repro():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print('\\n'.join(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout.split()
    assert "repro_torch.core.simulate" in out
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
