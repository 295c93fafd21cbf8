"""Edge-slot count: the degrees and frontier pushes of the PageRank loops
(``graph.structure`` ``out_degree``, ``in_degree``, ``push_or``,
``to_device_csr``).

``slot_count`` dispatches on where its tensors lie: on the CPU it runs the
plain version (``ref.slot_count_ref``, an ``index_add_``); on a CUDA
device it launches the hand-written kernel ``csrc/slot_count.cu``, which
issues no atomic for a slot whose weight is 0 and one warp-aggregated
atomic for the set slots of a warp that share an index.  A failed build
or launch raises.  ``LAUNCH_COUNTS`` counts launches of the kernel.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.build import check_arg
from repro_torch.kernels.slot_count.ref import slot_count_ref

__all__ = ["LAUNCH_COUNTS", "slot_count"]

LAUNCH_COUNTS: collections.Counter = collections.Counter()

_check = functools.partial(check_arg, "slot_count")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load("slot_count")
    lib.slot_count_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                                      + [ctypes.c_longlong, ctypes.c_void_p])
    lib.slot_count_launch.restype = ctypes.c_int
    return lib


def _launch_kernel(index, weight, n, gather, flags) -> torch.Tensor:
    E, dev = index.shape[0], index.device
    _check("index", index, torch.int32, (E,), dev)
    _check("weight", weight, torch.bool, (E,), dev)
    if gather is not None:
        _check("gather", gather, torch.int32, (E,), dev)
        _check("flags", flags, torch.bool, (flags.shape[0],), dev)
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().slot_count_launch(
            torch.cuda.current_device(), index.data_ptr(), weight.data_ptr(),
            None if gather is None else gather.data_ptr(),
            None if gather is None else flags.data_ptr(), out.data_ptr(), E,
            stream)
    if rc != 0:
        raise RuntimeError(f"slot_count kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCH_COUNTS["slot_count"] += 1
    return out


def slot_count(index: torch.Tensor, weight: torch.Tensor, n: int,
               gather: Optional[torch.Tensor] = None,
               flags: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32[n]: out[i] = the number of slots e with ``index[e] == i`` and
    ``weight[e]`` set, and, when ``gather`` is given, ``flags[gather[e]]``
    set too.  ``index``/``gather`` int32[E], ``weight`` bool[E], ``flags``
    bool; every index of a set slot lies in [0, n)."""
    if (gather is None) != (flags is None):
        raise ValueError("slot_count: gather and flags go together")
    if index.device.type == "cpu":
        return slot_count_ref(index, weight, n, gather, flags)
    if index.device.type != "cuda":
        raise ValueError(f"slot_count: no kernel for device {index.device}")
    return _launch_kernel(index, weight, n, gather, flags)
