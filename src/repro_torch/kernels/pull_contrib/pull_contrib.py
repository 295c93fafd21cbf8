"""Fixed-order pull sums over sorted edge slots, the same bit for bit from
run to run: the f64 contributions of the PageRank loops
(``core.pagerank._contrib``, ``core.extensions``: ``pull_contrib``) and
the port's other f64 segment sums (``pull_values``, ``segment_sum``), and
GraphSAGE's f32 neighbour-row sums (``pull_rows``,
``models.gnn.neighbor_sum``).

Their contract: each vertex's segment of sorted slots is cut into chunks
of at most ``chunk_slots`` slots (``PULL_CHUNK`` for the f64 sums,
``ROW_CHUNK`` for the rows), each chunk's terms are added in slot order
from +0.0, then the chunk sums in chunk order.  A segment of at most K
slots is summed one term at a time from +0.0.

Both dispatch on where their tensors lie: on the CPU they run the plain
versions (``ref.pull_contrib_ref``, ``ref.pull_rows_ref``); on a CUDA
device they launch the hand-written kernels of ``csrc/pull_contrib.cu``
over the chunk plan of ``segment_ops.plan`` (built on the device at the
first call on an ``order.ptr`` and cached with it).  A failed build or
launch raises.  ``LAUNCH_COUNTS`` counts calls that launch each kernel.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels.build import check_arg
from repro_torch.kernels.pull_contrib.ref import PULL_CHUNK, ROW_CHUNK, \
    PullOrder, pull_contrib_ref, pull_order, pull_rows_ref, sorted_slots
from repro_torch.kernels.segment_ops.plan import cached_plan

__all__ = ["LAUNCH_COUNTS", "PULL_CHUNK", "PullOrder", "ROW_CHUNK",
           "kernel_info", "pull_contrib", "pull_order", "pull_rows",
           "pull_values", "segment_sum", "sorted_slots"]

LAUNCH_COUNTS: collections.Counter = collections.Counter()

_check = functools.partial(check_arg, "pull_contrib")
_check_rows = functools.partial(check_arg, "pull_rows")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load("pull_contrib")
    lib.pull_contrib_launch.argtypes = ([ctypes.c_int]
                                        + [ctypes.c_void_p] * 14
                                        + [ctypes.c_int] * 4
                                        + [ctypes.c_void_p])
    lib.pull_contrib_launch.restype = ctypes.c_int
    lib.pull_rows_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                                     + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.pull_rows_launch.restype = ctypes.c_int
    lib.pull_contrib_info.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.pull_contrib_info.restype = ctypes.c_int
    return lib


def kernel_info(device=None) -> dict:
    """Registers a thread, resident blocks a SM, the SMs and threads a
    block of the f64 chunk kernel on the card; registers and blocks a SM
    of the row kernel, the weighted chunk kernel and the split kernel."""
    index = None if device is None else torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    info = (ctypes.c_int * 10)()
    rc = _lib().pull_contrib_info(index, ctypes.addressof(info))
    if rc != 0:
        raise RuntimeError(f"pull_contrib_info failed: CUDA error {rc}")
    return dict(registers=info[0], blocks_per_sm=info[1], sms=info[2],
                threads_per_block=info[3], row_registers=info[4],
                row_blocks_per_sm=info[5], weighted_registers=info[6],
                weighted_blocks_per_sm=info[7], split_registers=info[8],
                split_blocks_per_sm=info[9])


def _launch_kernel(order: PullOrder, ranks: torch.Tensor,
                   inv_deg: torch.Tensor, weight: Optional[torch.Tensor],
                   V: int, chunk_slots: int) -> torch.Tensor:
    E, N = order.src.shape[0], ranks.shape[0]
    dev = ranks.device
    _check("ranks", ranks, torch.float64, (N,), dev)
    _check("inv_deg", inv_deg, torch.float64, (N,), dev)
    _check("ptr", order.ptr, torch.int32, (V + 1,), dev)
    _check("src", order.src, torch.int32, (E,), dev)
    if weight is not None:
        _check("weight", weight, torch.float64, (E,), dev)
    if E >= 2**31 - 256:
        raise ValueError(f"pull_contrib: {E} edge slots exceed the "
                         "kernel's int32 slot offsets")
    out = torch.empty(V, dtype=torch.float64, device=dev)
    plan = cached_plan(order.ptr, E, chunk_slots)
    # the scratch: the chunks' partial sums, and the terms (unweighted) or
    # the (ranks, inv) pairs (weighted) the chunks gather
    partial = torch.empty(plan.num_partials, dtype=torch.float64,
                          device=dev)
    terms = torch.empty(N if weight is None else 2 * N,
                        dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().pull_contrib_launch(
            torch.cuda.current_device(),
            *(t.data_ptr() for t in plan[:7]), order.src.data_ptr(),
            ranks.data_ptr(), inv_deg.data_ptr(),
            None if weight is None else weight.data_ptr(),
            terms.data_ptr(), out.data_ptr(), partial.data_ptr(),
            plan.window.shape[0], plan.split_window.shape[0], V, N, stream)
    if rc != 0:
        raise RuntimeError(f"pull_contrib kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCH_COUNTS["pull_contrib"] += 1
    return out


def _dispatch(order: PullOrder, ranks: torch.Tensor, inv_deg: torch.Tensor,
              weight: Optional[torch.Tensor], V: int,
              chunk_slots: int) -> torch.Tensor:
    if chunk_slots < 1:
        raise ValueError(f"pull_contrib: chunk_slots must be >= 1, got "
                         f"{chunk_slots}")
    if ranks.device.type == "cpu":
        return pull_contrib_ref(order, ranks, inv_deg, weight, chunk_slots)
    if ranks.device.type != "cuda":
        raise ValueError(f"pull_contrib: no kernel for device {ranks.device}")
    return _launch_kernel(order, ranks, inv_deg, weight, V, chunk_slots)


def pull_contrib(order: PullOrder, ranks: torch.Tensor,
                 inv_deg: torch.Tensor,
                 weight: Optional[torch.Tensor] = None, *,
                 chunk_slots: int = PULL_CHUNK) -> torch.Tensor:
    """f64[V]: c[v] = the sum of ranks[u] * inv_deg[u] over v's live
    in-edges (u, v) of ``order``; with ``weight`` (f64, one per sorted
    slot) each term is (ranks[u] * weight[k]) * inv_deg[u].  The terms of
    each chunk of at most ``chunk_slots`` slots are added in slot order
    from +0.0, then a vertex's chunk sums in chunk order.  ``ranks`` and
    ``inv_deg`` are f64[V], V the order's vertices (``order.ptr`` is
    int32[V + 1])."""
    return _dispatch(order, ranks, inv_deg, weight, ranks.shape[0],
                     chunk_slots)


def pull_values(order: PullOrder, values: torch.Tensor,
                weight: Optional[torch.Tensor] = None, *,
                chunk_slots: int = PULL_CHUNK) -> torch.Tensor:
    """f64[V] (V + 1 = ``order.ptr``'s length): c[v] = the sum of
    values[src[k]] (times ``weight[k]``) over v's segment of sorted slots,
    in ``pull_contrib``'s chunked order.  ``values`` is f64[N] of any
    length N: every ``order.src`` must lie in [0, N), which the caller
    guarantees and the kernel does not check (it reads ``values[src]``
    unguarded)."""
    return _dispatch(order, values, torch.ones_like(values), weight,
                     order.ptr.shape[0] - 1, chunk_slots)


def segment_sum(ptr: torch.Tensor, weight: torch.Tensor, *,
                chunk_slots: int = PULL_CHUNK) -> torch.Tensor:
    """f64[V]: the sum of ``weight[k]`` over each segment
    [ptr[v], ptr[v + 1]) of sorted slots, in ``pull_contrib``'s chunked
    order: the weighted ``pull_values`` with every source 0 and the one
    value 1."""
    one = torch.ones(1, dtype=torch.float64, device=weight.device)
    src = torch.zeros(weight.shape[0], dtype=torch.int32,
                      device=weight.device)
    return pull_values(PullOrder(ptr, src), one, weight,
                       chunk_slots=chunk_slots)


def _launch_rows(order: PullOrder, x: torch.Tensor,
                 chunk_slots: int) -> torch.Tensor:
    V, E = order.ptr.shape[0] - 1, order.src.shape[0]
    dev = x.device
    d = x.shape[1]
    _check_rows("ptr", order.ptr, torch.int32, (V + 1,), dev)
    _check_rows("src", order.src, torch.int32, (E,), dev)
    _check_rows("x", x, torch.float32, (x.shape[0], d), dev)
    if chunk_slots < 1:
        raise ValueError(f"pull_rows: chunk_slots must be >= 1, got "
                         f"{chunk_slots}")
    if E >= 2**31 - 256:
        raise ValueError(f"pull_rows: {E} edge slots exceed the kernel's "
                         "int32 slot offsets")
    out = torch.empty(V, d, dtype=torch.float32, device=dev)
    if V == 0 or d == 0:
        return out
    # the chunk plan of gated_spmm, over vertices and their sorted slots
    plan = cached_plan(order.ptr, E, chunk_slots)
    partial = torch.empty(plan.num_partials * d, dtype=torch.float32,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().pull_rows_launch(
            torch.cuda.current_device(),
            *(t.data_ptr() for t in plan[:7]), order.src.data_ptr(),
            x.data_ptr(), out.data_ptr(), partial.data_ptr(),
            plan.window.shape[0], plan.split_window.shape[0], V, d, stream)
    if rc != 0:
        raise RuntimeError(f"pull_rows kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCH_COUNTS["pull_rows"] += 1
    return out


def pull_rows(order: PullOrder, x: torch.Tensor, *,
              chunk_slots: int = ROW_CHUNK) -> torch.Tensor:
    """f32[V, D]: out[v] = the sum of the rows x[u] (x: f32[N, D]) over
    v's live in-edges (u, v) of ``order``: each chunk of at most
    ``chunk_slots`` slots summed in slot order from +0.0, then a vertex's
    chunks added in chunk order."""
    if x.dim() != 2:
        raise ValueError(f"pull_rows: x must be [N, D], got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return pull_rows_ref(order, x, chunk_slots)
    if x.device.type != "cuda":
        raise ValueError(f"pull_rows: no kernel for device {x.device}")
    return _launch_rows(order, x, chunk_slots)
