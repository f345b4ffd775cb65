"""Build the port's CUDA sources into shared libraries, at first use.

Each ``csrc/*.cu`` file exports plain C functions and is compiled by
``nvcc`` into ``build/repro_torch/<name>-<hash>.so`` under the
repository root, then loaded with ``ctypes``.  The hash covers the
source text and the command line, so an edited source or flag rebuilds
and an unchanged one is loaded from the cache.  Nothing here runs at
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
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: ``-fmad=false`` is load-bearing: the route_score kernel reproduces the
#: host's float64 scores bit for bit, and a fused multiply-add rounds
#: ``lam*x + c*y`` once instead of twice
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc`` if present, else the first ``nvcc`` on
    ``PATH``, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def nvcc_command(src: Path, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built for its current text."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its cached library is missing, and
    return the loaded library.  Raises ``RuntimeError`` with the
    compiler's output if ``nvcc`` is missing or fails."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        out = library_path(name)
        if not out.exists():
            nvcc = nvcc_path()
            if not Path(nvcc).exists():
                raise RuntimeError(
                    f"cannot build {name}.cu: nvcc not found ({nvcc}); "
                    "set CUDA_HOME or put nvcc on PATH")
            out.parent.mkdir(parents=True, exist_ok=True)
            # build to a private name, then rename: a concurrent build
            # never loads a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
            os.close(fd)
            try:
                proc = subprocess.run(nvcc_command(CSRC / f"{name}.cu",
                                                   Path(tmp)),
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {name}.cu "
                        f"(exit {proc.returncode}):\n{proc.stderr}")
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
        return lib
