"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each kernel is one ``.cu`` file with a plain C interface, compiled for
Hopper (``sm_90a``) into a shared library under ``repro_torch/_build/``
(listed in ``.gitignore``).  The library's file name carries a digest of
its source and flags, so an edited source is rebuilt and an unchanged one
is reused.  Nothing is built when a module is imported: the first call
that needs a kernel builds it.

A failed build raises with the compiler's output; there is no fallback.
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

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parent / "_build"
SOURCES = {
    "frontier_spmv": _KERNELS_DIR / "pagerank_spmv" / "csrc"
    / "frontier_spmv.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one PyTorch
    found, else ``nvcc`` on ``PATH``."""
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME
        homes.append(CUDA_HOME)
    except ImportError:
        pass
    for home in homes:
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def library_path(name: str) -> Path:
    src = SOURCES[name].read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(name: str) -> dict:
    """Compile the named kernel unless it is built already.

    Returns ``dict(path, seconds, log)``; ``seconds`` is 0 and ``log``
    empty for a library that was already built.  Raises ``RuntimeError``
    with the compiler output on failure.
    """
    path = library_path(name)
    if path.exists():
        return dict(path=path, seconds=0.0, log="")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA kernel build failed: {name} (nvcc exit "
                           f"{proc.returncode})\n{proc.stdout}")
    os.replace(tmp, path)              # atomic: concurrent builds agree
    return dict(path=path, seconds=time.perf_counter() - t0,
                log=proc.stdout)


def load(name: str) -> ctypes.CDLL:
    """The named kernel's shared library, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)["path"]))
            _LIBS[name] = lib
        return lib
