"""Build a CUDA source under ``kernels/csrc`` with ``nvcc`` into a shared
library with a plain C interface, and load it with ``ctypes``.

The library lands in ``<repo>/build/kernels/`` (listed in ``.gitignore``),
named by a hash of the source and flags, so a fresh checkout builds on
first use and an edited source rebuilds. Nothing is built at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return path


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"{name}-{digest}.so"
    log_path = BUILD_DIR / f"{name}-{digest}.log"
    if not lib_path.exists():
        tmp = BUILD_DIR / f"{name}-{digest}.{os.getpid()}.tmp.so"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    _LOGS[name] = log_path.read_text() if log_path.exists() else ""
    _LIBS[name] = ctypes.CDLL(str(lib_path))
    return _LIBS[name]


def build_log(name: str) -> str:
    """The compiler's ``-Xptxas -v`` report (registers, shared memory,
    spills) of the library ``load(name)`` built."""
    return _LOGS.get(name, "")
