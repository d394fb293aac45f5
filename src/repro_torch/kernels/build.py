"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each source in ``csrc/`` (one per kernel) is compiled by its own ``nvcc``
into a shared library with a plain C interface; all sources compile
concurrently.  Builds go to ``_build/`` beside this file (listed in
``.gitignore``), keyed by a hash of the sources and flags, so a checkout
builds what it needs and a changed source rebuilds.  Nothing is built when
the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

__all__ = ["BuildError", "SOURCES", "NVCC_FLAGS", "build_all", "load_all",
           "library", "build_log"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# kernel library name -> its source file (headers are hashed with every one)
SOURCES = {"spm_stack": "spm_stack.cu", "spm_stack_bwd": "spm_stack_bwd.cu",
           "spm_block": "spm_block.cu", "spm_block_bwd": "spm_block_bwd.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_log: Dict[str, str] = {}


class BuildError(RuntimeError):
    """A kernel source failed to compile or its library failed to load."""


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise BuildError("nvcc not found (CUDA toolkit required)")
    return path


def _digest(src: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / src]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(SOURCES[name])}.so"


def build_all() -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all at once.
    Returns the wall seconds of each build (0.0 when already built); the
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept for ``build_log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in SOURCES.items():
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    secs = {name: 0.0 for name in SOURCES}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        text, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        _log[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{text}")
            continue
        os.replace(tmp, out)       # atomic: a half-written .so never loads
    if failed:
        raise BuildError("\n".join(failed))
    return secs


def load_all() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library once per process."""
    with _lock:
        if len(_libs) < len(SOURCES):
            build_all()
            for name in SOURCES:
                try:
                    _libs[name] = ctypes.CDLL(str(_target(name)))
                except OSError as e:
                    raise BuildError(f"{name}: cannot load: {e}") from e
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel (building all at first call)."""
    return load_all()[name]


def build_log(name: str) -> str:
    """nvcc's output for ``name`` from this process's build ('' when the
    library was already built)."""
    return _log.get(name, "")
