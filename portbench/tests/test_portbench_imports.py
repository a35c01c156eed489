"""Nothing the benchmark runs imports JAX or the JAX package `repro`,
and its plain reference imports nothing of the port either. Modules are
compared by their whole top-level name: `repro_torch` is not `repro`."""
import ast
from pathlib import Path

import pytest

from portbench.harness import runner

HERE = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "repro"}


def _sources(sub=""):
    return sorted(p for p in (HERE / sub).rglob("*.py")
                  if "tests" not in p.relative_to(HERE).parts)


def _imports(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_import(path):
    assert not _imports(path) & JAX


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not _imports(path) & (JAX | {"repro_torch", "portbench"})


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types
    for name in ("repro_torch", "repro_torch.sim", "reprox", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    assert runner.forbidden_modules() == ["repro"]
