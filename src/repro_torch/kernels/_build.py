"""Build a CUDA source under ``kernels/csrc`` with ``nvcc`` into a shared
library with a plain C interface, and load it with ``ctypes``.

The library lands in ``<repo>/build/kernels/`` (listed in ``.gitignore``),
named by a hash of the source, the headers of ``csrc/`` and the flags, so a
fresh checkout builds on first use and an edited source or header
rebuilds. Nothing is built at import time. ``load_all`` starts one ``nvcc``
per source at once, so several kernels build in the time of the slowest.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

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


def _paths(name: str):
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return (src, BUILD_DIR / f"{name}-{digest}.so",
            BUILD_DIR / f"{name}-{digest}.log")


def load_all(names: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load ``csrc/<name>.cu`` for every name, with
    the missing builds running side by side."""
    wanted = list(dict.fromkeys(names))
    names = [n for n in wanted if n not in _LIBS]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        src, lib_path, log_path = _paths(name)
        if lib_path.exists():
            continue
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp.so")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((src, tmp, lib_path, log_path, proc))
    failed = []
    for src, tmp, lib_path, log_path, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src}:\n{err}")
            continue
        log_path.write_text(out + err)
        os.replace(tmp, lib_path)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        _, lib_path, log_path = _paths(name)
        _LOGS[name] = log_path.read_text() if log_path.exists() else ""
        _LIBS[name] = ctypes.CDLL(str(lib_path))
    return {n: _LIBS[n] for n in wanted}


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    if name not in _LIBS:
        load_all([name])
    return _LIBS[name]


def build_log(name: str) -> str:
    """The compiler's ``-Xptxas -v`` report (registers, shared memory,
    spills) of the library ``load(name)`` built."""
    return _LOGS.get(name, "")
