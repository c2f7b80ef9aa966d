"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` exposes a plain C interface. It is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library and
loaded with ``ctypes``; nothing includes PyTorch's headers, so a build
takes seconds. Libraries go into ``paddle_tpu_torch/_build/`` (listed in
``.gitignore``) under a name carrying a hash of the source and the
flags, so an edited source is never served by a stale library. A build
happens at first use, from the checkout's sources only.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "build", "load"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the port's CUDA kernels are built on the machine with the card")
    return path


def _source(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    with open(_source(name), "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _ptxas_summary(log: str) -> str:
    """The ``-Xptxas -v`` lines that give registers, shared memory and
    spills per kernel."""
    keep = [ln.strip() for ln in log.splitlines()
            if re.search(r"registers|spill|Compiling entry", ln)]
    return "\n".join(keep)


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless a current library is on disk.
    Returns ``{"path", "built", "seconds", "ptxas"}`` (``built`` is False
    when the library on disk was reused). Raises with the compiler's
    output when the build fails."""
    out = library_path(name)
    if os.path.exists(out):
        return {"path": out, "built": False, "seconds": 0.0, "ptxas": ""}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _source(name)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return {"path": out, "built": True, "seconds": seconds,
            "ptxas": _ptxas_summary(proc.stdout)}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name)["path"])
            _libs[name] = lib
        return lib
