"""Fixed-order f64 pull sum: the contributions of the f64 PageRank loop
(``core.pagerank._contrib``), the same bit for bit from run to run.

``pull_contrib`` dispatches on where its tensors lie: on the CPU it runs
the plain version (``ref.pull_contrib_ref``); on a CUDA device it
launches the hand-written kernel ``csrc/pull_contrib.cu``, which adds each
vertex's terms in slot order from +0.0, as the CPU does.  A failed build
or launch raises.  ``LAUNCH_COUNTS`` counts launches of the kernel.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels.build import check_arg
from repro_torch.kernels.pull_contrib.ref import PullOrder, \
    pull_contrib_ref, pull_order

__all__ = ["LAUNCH_COUNTS", "PullOrder", "kernel_info", "pull_contrib",
           "pull_order"]

LAUNCH_COUNTS: collections.Counter = collections.Counter()

_check = functools.partial(check_arg, "pull_contrib")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load("pull_contrib")
    lib.pull_contrib_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                                        + [ctypes.c_int, ctypes.c_void_p])
    lib.pull_contrib_launch.restype = ctypes.c_int
    lib.pull_contrib_info.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.pull_contrib_info.restype = ctypes.c_int
    return lib


def kernel_info(device=None) -> dict:
    """Registers a thread, resident blocks a SM, the SMs and threads a
    block of the kernel on the card."""
    index = None if device is None else torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    info = (ctypes.c_int * 4)()
    rc = _lib().pull_contrib_info(index, ctypes.addressof(info))
    if rc != 0:
        raise RuntimeError(f"pull_contrib_info failed: CUDA error {rc}")
    return dict(registers=info[0], blocks_per_sm=info[1], sms=info[2],
                threads_per_block=info[3])


def _launch_kernel(order: PullOrder, ranks: torch.Tensor,
                   inv_deg: torch.Tensor) -> torch.Tensor:
    V, E = ranks.shape[0], order.src.shape[0]
    dev = ranks.device
    _check("ranks", ranks, torch.float64, (V,), dev)
    _check("inv_deg", inv_deg, torch.float64, (V,), dev)
    _check("ptr", order.ptr, torch.int32, (V + 1,), dev)
    _check("src", order.src, torch.int32, (E,), dev)
    if E >= 2**31 - 256:
        raise ValueError(f"pull_contrib: {E} edge slots exceed the "
                         "kernel's int32 slot offsets")
    out = torch.empty_like(ranks)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().pull_contrib_launch(
            torch.cuda.current_device(), order.ptr.data_ptr(),
            order.src.data_ptr(), ranks.data_ptr(), inv_deg.data_ptr(),
            out.data_ptr(), V, stream)
    if rc != 0:
        raise RuntimeError(f"pull_contrib kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCH_COUNTS["pull_contrib"] += 1
    return out


def pull_contrib(order: PullOrder, ranks: torch.Tensor,
                 inv_deg: torch.Tensor) -> torch.Tensor:
    """f64[V]: c[v] = sum of ranks[u] * inv_deg[u] over v's live in-edges
    (u, v) of ``order``, added in slot order from +0.0."""
    if ranks.device.type == "cpu":
        return pull_contrib_ref(order, ranks, inv_deg)
    if ranks.device.type != "cuda":
        raise ValueError(f"pull_contrib: no kernel for device {ranks.device}")
    return _launch_kernel(order, ranks, inv_deg)
