"""Build and load the port's native libraries.

Each source ``csrc/<name>.cu`` exposes a plain C interface. It is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library and
loaded with ``ctypes``; nothing includes PyTorch's headers, so a build
takes seconds. A host-only source ``csrc/<name>.cpp`` (the DataLoader's
shared-memory queue) is compiled the same way with ``g++``. Libraries go
into ``paddle_tpu_torch/_build/`` (listed in ``.gitignore``) under a
name carrying a hash of the source, of every header under ``csrc/`` and
of the flags, so an edited source or header is never served by a stale
library. A build happens at first use, from the checkout's sources only.
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

__all__ = ["BUILD_DIR", "CSRC_DIR", "GXX_FLAGS", "NVCC_FLAGS", "build",
           "build_all", "load"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC", "-lpthread"]

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


def _gxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if not found:
        raise RuntimeError("g++ not found (PATH, $CXX): the port's host "
                           "libraries are built with it")
    return found


def _source(name: str) -> str:
    cu = os.path.join(CSRC_DIR, f"{name}.cu")
    return cu if os.path.exists(cu) else os.path.join(CSRC_DIR,
                                                       f"{name}.cpp")


def _is_host(name: str) -> bool:
    return _source(name).endswith(".cpp")


def _command(name: str, out: str):
    if _is_host(name):
        return [_gxx(), "-o", out, _source(name), *GXX_FLAGS]
    return [_nvcc(), *NVCC_FLAGS, "-o", out, _source(name)]


def library_path(name: str) -> str:
    flags = GXX_FLAGS if _is_host(name) else NVCC_FLAGS
    h = hashlib.sha256(" ".join(flags).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [_source(name)] + [os.path.join(CSRC_DIR, f)
                                   for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _ptxas_summary(log: str) -> str:
    """The ``-Xptxas -v`` lines that give registers, shared memory and
    spills per kernel, and any warning ptxas gives."""
    keep = [ln.strip() for ln in log.splitlines()
            if re.search(r"registers|spill|Compiling entry|warning", ln)]
    return "\n".join(keep)


def build_all(names) -> Dict[str, dict]:
    """Compile ``csrc/<name>.cu`` (or ``.cpp``) for every name whose
    current library is not on disk, one ``nvcc`` (or ``g++``) per source,
    all started together. Returns
    ``{name: {"path", "built", "seconds", "ptxas"}}`` (``built`` is False
    when the library on disk was reused). Raises with the compiler's
    output when a build fails, after stopping the other builds."""
    results: Dict[str, dict] = {}
    running = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            results[name] = {"path": out, "built": False, "seconds": 0.0,
                             "ptxas": ""}
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            _command(name, tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    try:
        for name, (proc, tmp, out, t0) in running.items():
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"build failed for {name} (exit "
                                   f"{proc.returncode}):\n{log}")
            os.replace(tmp, out)
            results[name] = {"path": out, "built": True, "seconds": seconds,
                             "ptxas": _ptxas_summary(log)}
    finally:
        for proc, _, _, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


def build(name: str) -> dict:
    """:func:`build_all` for one source."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (or ``.cpp``), built at
    first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name)["path"])
            _libs[name] = lib
        return lib
