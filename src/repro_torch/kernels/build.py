"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  Libraries land
in ``build/kernels/`` at the repository root (git-ignored), named by a
hash of the source, the headers it includes and the flags, so a changed
source is never served from a stale build.  Building happens at first
use, never at import: the CPU tests import every module on machines with
no CUDA toolkit.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[tuple, ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()


class LaunchCounter:
    """Launches of one kernel: a wrapper adds one where it launches."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def n(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


def nvcc() -> str:
    """The CUDA toolkit's compiler: on ``PATH``, else under the toolkit
    PyTorch finds (``CUDA_HOME``)."""
    found = shutil.which("nvcc")
    if found is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
            found = os.path.join(CUDA_HOME, "bin", "nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the Hopper kernels are built "
                           "with the CUDA toolkit at first use")
    return found


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the flags, the
    source and the headers of ``csrc/`` it includes."""
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in re.findall(rb'#include "([^"]+)"', src):
        src += (CSRC / header.decode()).read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def compile_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source not built yet, one ``nvcc`` each, all
    started together.  → ``{name: compiler log}`` (``-Xptxas -v`` output:
    registers, shared memory and spills per kernel).  Raises with the
    compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    logs: Dict[str, str] = {}
    for name in names:
        out = library_path(name)
        log = out.with_suffix(".log")
        if out.exists():
            logs[name] = log.read_text() if log.exists() else ""
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, log)
    failed: List[str] = []
    for name, (p, tmp, out, log) in procs.items():
        text, _ = p.communicate()
        logs[name] = text
        if p.returncode != 0:
            failed.append(f"{name} (nvcc exit {p.returncode}):\n{text}")
            continue
        # processes that build at once each write their own temporaries
        # and rename them into place: a reader sees a whole file or none
        tmp_log = tmp.with_suffix(".log")
        tmp_log.write_text(text)
        os.replace(tmp_log, log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of kernel library ``name``, built on
    first use."""
    with _LOCK:
        fn = _FUNCS.get((name, symbol))
        if fn is None:
            lib = _LIBS.get(name)
            if lib is None:
                compile_all([name])
                lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _FUNCS[(name, symbol)] = fn
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
