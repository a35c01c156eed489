"""Build the CUDA kernels at first use and load them with ctypes.

Every `csrc/*.cu` is compiled by `nvcc` for `sm_90a` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds,
not minutes). All sources compile in parallel, one `nvcc` each, into
`kernels/_build/<hash>/`, keyed by a hash of the sources and flags: an
edited source builds anew, an unchanged one is loaded from disk. A
failed build raises with the compiler's output; there is no fallback.

The `ptxas -v` report (registers, shared memory, spills per kernel) is
kept beside each library as `<name>.log`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source with the CUDA toolkit")
    return nvcc


def build_dir() -> Path:
    """Directory of this source tree's libraries (hash of sources+flags)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> float:
    """Compile every missing library in parallel and load them all.
    Returns the seconds it took (0 when everything was already loaded)."""
    if _LIBS:
        return 0.0
    t0 = time.perf_counter()
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in sources:
        lib = out / f"lib{src.stem}.so"
        if lib.exists():
            continue
        # compile to a private name, then rename: a concurrent builder
        # never loads a half-written library
        tmp = out / f"lib{src.stem}.{os.getpid()}.so.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        (out / f"{src.stem}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("nvcc failed\n" + "\n".join(failures))
    for src in sources:
        _LIBS[src.stem] = ctypes.CDLL(str(out / f"lib{src.stem}.so"))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<name>.cu` (builds on first use)."""
    build_all()
    return _LIBS[name]
