"""Build the port's CUDA sources into shared libraries, at first use.

Each ``csrc/*.cu`` file exports plain C functions and is compiled by
``nvcc`` into ``build/repro_torch/<name>-<hash>.so`` under the
repository root, then loaded with ``ctypes``.  The hash covers the
source text, the shared headers (``csrc/*.cuh``) and the source's own
command line, so an edited source, header or flag rebuilds and an
unchanged one is loaded from the cache.  Nothing here runs at
import time; a machine without ``nvcc`` only fails when a kernel is
actually launched.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: flags of one source on top of ``NVCC_FLAGS``.  ``-fmad=false`` is
#: load-bearing for route_score only: that kernel reproduces the host's
#: float64 scores bit for bit, and a fused multiply-add rounds
#: ``lam*x + c*y`` once instead of twice.  The attention kernels
#: accumulate in f32 within a tolerance and keep fused multiply-adds.
SOURCE_FLAGS = {"route_score": ["-fmad=false"]}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: ptxas's report (``-Xptxas -v``: registers, shared memory and spills of
#: every kernel) of each source built by this process
PTXAS: Dict[str, str] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc`` if present, else the first ``nvcc`` on
    ``PATH``, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def nvcc_flags(name: str) -> List[str]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, [])


def nvcc_command(src: Path, out: Path) -> List[str]:
    return [nvcc_path(), *nvcc_flags(src.stem), "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built for its current text, headers and
    flags."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _compile(names: Sequence[str]):
    """Compile the missing libraries of ``names``: one ``nvcc`` for each,
    all started together.  Caller holds ``_LOCK``."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    nvcc = nvcc_path()
    if not Path(nvcc).exists():
        raise RuntimeError(
            f"cannot build {', '.join(todo)}: nvcc not found ({nvcc}); "
            "set CUDA_HOME or put nvcc on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to private names, then rename: a concurrent build never
    # loads a half-written library
    jobs = []
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(nvcc_command(CSRC / f"{name}.cu",
                                                 Path(tmp)),
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            jobs.append((name, tmp, proc))
        errors = []
        for name, tmp, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {name}.cu "
                              f"(exit {proc.returncode}):\n{err}")
            else:
                PTXAS[name] = err
                os.replace(tmp, library_path(name))
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


def build(names: Sequence[str]):
    """Compile every missing library of ``names`` in parallel and load
    them all.  Raises ``RuntimeError`` with the compiler's output if
    ``nvcc`` is missing or fails."""
    with _LOCK:
        _compile(names)
    for name in names:
        load(name)


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its cached library is missing, and
    return the loaded library.  Raises ``RuntimeError`` with the
    compiler's output if ``nvcc`` is missing or fails."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _compile([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib
