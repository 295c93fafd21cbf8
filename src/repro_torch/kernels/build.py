"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each kernel is one ``.cu`` file with a plain C interface, compiled for
Hopper (``sm_90a``) into its own shared library under ``repro_torch/_build/``
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
from typing import Dict, Iterable, Optional

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parent / "_build"
SOURCES = {
    "frontier_spmv": _KERNELS_DIR / "pagerank_spmv" / "csrc"
    / "frontier_spmv.cu",
    "walk_repair": _KERNELS_DIR / "walk_repair" / "csrc" / "walk_repair.cu",
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


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: all of ``SOURCES``) unless they
    are built already, one ``nvcc`` per source, all started together.

    Returns ``{name: dict(path, seconds, log)}``; ``seconds`` is 0 and
    ``log`` empty for a library that was already built.  Raises
    ``RuntimeError`` with the compiler output of every failed build.
    """
    names = list(SOURCES if names is None else names)
    out, jobs = {}, {}
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = dict(path=path, seconds=0.0, log="")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, path, time.perf_counter())
    failed = []
    for name, (proc, tmp, path, t0) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, path)          # atomic: concurrent builds agree
        out[name] = dict(path=path, seconds=time.perf_counter() - t0,
                         log=log)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The named kernel's shared library, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]["path"]))
            _LIBS[name] = lib
        return lib
