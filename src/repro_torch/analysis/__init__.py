"""repro_torch.analysis — the port's static analysis, pure `ast`.

The counterpart of the JAX package's `repro.analysis`, with checkers for
the hazards the port has met (see `checkers.py`): host-sync,
capture-safety, dtype-drift, fingerprint-coverage and retrace-hazard.
It imports nothing of the code it scans, nor `jax`, nor anything of
`repro`. Run it:

    PYTHONPATH=src python -m repro_torch.analysis --check

`--check` exits nonzero on any finding not in the committed baseline
(`src/repro_torch/analysis/baseline.json`) and on any baseline entry
without a justification; stale entries (code fixed, entry left behind)
are reported but do not fail. An inline `# lint-torch: disable=<checker>`
on (or directly above) a line silences it at the source.

The runtime side is `repro_torch.runtime.guards` (`no_retrace`, the
finite checks) and the captured loops themselves, which raise on a
failed capture: the lint finds the structure on the CPU, before a card
ever meets it.
"""
from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence

from .baseline import (load_baseline, partition, save_baseline,  # noqa: F401
                       unjustified)
from .checkers import Checker, ModuleSource, Project, default_checkers
from .findings import Finding, assign_occurrences

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
DEFAULT_TARGETS = ("src/repro_torch",)
DEFAULT_BASELINE = os.path.join("src", "repro_torch", "analysis",
                                "baseline.json")


def _run(mods: Sequence[ModuleSource],
         checkers: Optional[Sequence[Checker]]) -> List[Finding]:
    out: List[Finding] = []
    proj = None
    for checker in checkers or default_checkers():
        if checker.scope == "module":
            for mod in mods:
                out.extend(checker.check(mod))
        else:
            proj = proj or Project(mods)
            out.extend(checker.check_project(proj))
    return out


def analyze_source(text: str, path: str = "<string>",
                   checkers: Optional[Sequence[Checker]] = None,
                   ) -> List[Finding]:
    """Run every checker over one source string as a project of one
    module (the unit the tests use): its captured bodies, keys and
    fingerprints are those it defines itself."""
    return assign_occurrences(_run([ModuleSource.parse(text, path)],
                                   checkers))


def iter_python_files(targets: Iterable[str], root: str = None,
                      ) -> List[str]:
    """Repo-relative paths of every .py under the target files/dirs."""
    root = root or REPO_ROOT
    out = []
    for target in targets:
        full = target if os.path.isabs(target) else os.path.join(root, target)
        if os.path.isfile(full):
            out.append(os.path.relpath(full, root))
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = [d for d in sorted(dirnames)
                           if d not in ("__pycache__", "_build")]
            for name in sorted(filenames):
                if name.endswith(".py"):
                    out.append(os.path.relpath(
                        os.path.join(dirpath, name), root))
    return sorted(set(p.replace(os.sep, "/") for p in out))


def analyze_paths(targets: Sequence[str] = DEFAULT_TARGETS,
                  root: str = None,
                  checkers: Optional[Sequence[Checker]] = None,
                  ) -> List[Finding]:
    """Run every checker over the target files/dirs as one project;
    paths in findings are repo-relative."""
    root = root or REPO_ROOT
    mods: List[ModuleSource] = []
    findings: List[Finding] = []
    for rel in iter_python_files(targets, root):
        with open(os.path.join(root, rel)) as f:
            text = f.read()
        try:
            mods.append(ModuleSource.parse(text, rel))
        except SyntaxError as e:
            findings.append(Finding(checker="parse-error", path=rel,
                                    line=e.lineno or 0,
                                    message=f"does not parse: {e.msg}"))
    findings.extend(_run(mods, checkers))
    return assign_occurrences(findings)
