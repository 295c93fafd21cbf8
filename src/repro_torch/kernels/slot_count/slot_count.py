"""Edge-slot counts: the degrees and frontier pushes of the PageRank loops
(``graph.structure`` ``out_degree``, ``in_degree``, ``push_or``).

``slot_count`` counts slots by an index (the counts by src: out-degrees,
the row sum's source ranking).  The counts by dst ride a dst-sorted slot
order (``pull_contrib.pull_order``): ``segment_bounds`` writes the order's
``ptr`` from its sorted keys (the in-degrees are its differences), and
``segment_or`` ORs each vertex's segment of flags (``push_or``).

Each dispatches on where its tensors lie: on the CPU it runs the plain
version (``ref.slot_count_ref``, an ``index_add_``; ``ref.
segment_bounds_ref``, a ``searchsorted``; ``ref.segment_or_ref``); on a
CUDA device it launches its hand-written kernel in ``csrc/slot_count.cu``:
``slot_count`` issues no atomic for a slot whose weight is 0 and one
warp-aggregated atomic for the set slots of a warp that share an index;
the other two issue none.  On a ``meta`` tensor each runs its launch
path with no launch (``kernels.work``).  A failed build or launch
raises.
``LAUNCH_COUNTS`` counts launches of each kernel.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import work
from repro_torch.kernels.build import check_arg
from repro_torch.kernels.slot_count.ref import segment_bounds_ref, \
    segment_or_ref, slot_count_ref

__all__ = ["LAUNCH_COUNTS", "segment_bounds", "segment_or", "slot_count"]

LAUNCH_COUNTS: collections.Counter = collections.Counter()


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels.build import load
    lib = load("slot_count")
    lib.slot_count_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                                      + [ctypes.c_longlong, ctypes.c_void_p])
    lib.slot_count_launch.restype = ctypes.c_int
    lib.segment_bounds_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.segment_bounds_launch.restype = ctypes.c_int
    lib.segment_or_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4
        + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
           ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p])
    lib.segment_or_launch.restype = ctypes.c_int
    return lib


def _device(t: torch.Tensor, kernel: str) -> bool:
    """True for a CPU tensor (run the plain version), False for a CUDA one
    (launch the kernel) or a meta one (the launch path, no launch); raise
    for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type not in ("cuda", "meta"):
        raise ValueError(f"{kernel}: no kernel for device {t.device}")
    return False


def _launch(kernel: str, fn, *args) -> None:
    """Launch ``fn`` on the current stream of the tensors' device; raise
    on a nonzero CUDA error and count the launch."""
    dev = torch.cuda.current_device()
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(dev, *args, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
    LAUNCH_COUNTS[kernel] += 1


def _check_slot_int32(kernel: str, num_slots: int) -> None:
    if num_slots >= 2**31 - 4:
        raise ValueError(f"{kernel}: {num_slots} edge slots exceed the "
                         "kernel's int32 positions")


def slot_count(index: torch.Tensor, weight: torch.Tensor, n: int,
               gather: Optional[torch.Tensor] = None,
               flags: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32[n]: out[i] = the number of slots e with ``index[e] == i`` and
    ``weight[e]`` set, and, when ``gather`` is given, ``flags[gather[e]]``
    set too.  ``index``/``gather`` int32[E], ``weight`` bool[E], ``flags``
    bool; every index of a set slot lies in [0, n)."""
    if (gather is None) != (flags is None):
        raise ValueError("slot_count: gather and flags go together")
    if _device(index, "slot_count"):
        return slot_count_ref(index, weight, n, gather, flags)
    check = functools.partial(check_arg, "slot_count")
    E, dev = index.shape[0], index.device
    check("index", index, torch.int32, (E,), dev)
    check("weight", weight, torch.bool, (E,), dev)
    if gather is not None:
        check("gather", gather, torch.int32, (E,), dev)
        check("flags", flags, torch.bool, (flags.shape[0],), dev)
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    if E == 0:
        return out
    if dev.type == "meta":                 # the dry-run: no launch
        work.record("slot_count", *work.slot_count_work(
            E, n, E, 4 * E, 0 if gather is None else 4 * E,
            gather is not None), integer=True)
        return out
    with torch.cuda.device(dev):
        _launch("slot_count", _lib().slot_count_launch, index.data_ptr(),
                weight.data_ptr(),
                None if gather is None else gather.data_ptr(),
                None if gather is None else flags.data_ptr(),
                out.data_ptr(), E)
    return out


def segment_bounds(keys: torch.Tensor, n: int) -> torch.Tensor:
    """int32[n + 1]: ptr[v] = the first position of the sorted int32
    ``keys`` (each in [0, n]; the dead slots keyed n, last) whose key is
    >= v: the keys equal to v are [ptr[v], ptr[v + 1]), and the dead ones
    begin at ptr[n].  No atomic and no host read on the card."""
    if _device(keys, "segment_bounds"):
        return segment_bounds_ref(keys, n)
    E, dev = keys.shape[0], keys.device
    check_arg("segment_bounds", "keys", keys, torch.int32, (E,), dev)
    _check_slot_int32("segment_bounds", E)
    ptr = torch.empty(n + 1, dtype=torch.int32, device=dev)
    if dev.type == "meta":                 # the dry-run: no launch
        work.record("segment_bounds", *work.segment_bounds_work(E, n),
                    integer=True)
        return ptr
    with torch.cuda.device(dev):
        _launch("segment_bounds", _lib().segment_bounds_launch,
                keys.data_ptr(), E, n, ptr.data_ptr())
    return ptr


def segment_or(ptr: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
               flags: torch.Tensor) -> torch.Tensor:
    """bool[V] (V + 1 = ``ptr``'s length): out[v] = the OR of
    ``flags[src[k]]`` over v's segment [ptr[v], ptr[v + 1]) of a sorted
    slot order (``ptr``, its sources ``src`` and sorted keys ``dst``,
    int32[E]); the slots from ptr[V] on are dead.  Every live source lies
    in [0, len(flags)).  Reads the live count on the card: no host read,
    and no atomic.  On the card a first launch packs the flags into bits
    (and zeroes the output), the second ORs."""
    if _device(src, "segment_or"):
        return segment_or_ref(ptr, src, dst, flags)
    check = functools.partial(check_arg, "segment_or")
    V, E, dev = ptr.shape[0] - 1, src.shape[0], src.device
    check("ptr", ptr, torch.int32, (V + 1,), dev)
    check("src", src, torch.int32, (E,), dev)
    check("dst", dst, torch.int32, (E,), dev)
    check("flags", flags, torch.bool, (flags.shape[0],), dev)
    _check_slot_int32("segment_or", E)
    n = flags.shape[0]
    out = torch.empty(V, dtype=torch.bool, device=dev)  # zeroed on the card
    bits = torch.empty((n + 31) // 32, dtype=torch.int32, device=dev)
    if dev.type == "meta":                 # the dry-run: no launch
        work.record("segment_or", *work.segment_or_work(E, V, 4 * E, 4 * E),
                    integer=True)
        return out
    with torch.cuda.device(dev):
        _launch("segment_or", _lib().segment_or_launch, src.data_ptr(),
                dst.data_ptr(), ptr[V:].data_ptr(), flags.data_ptr(), n,
                bits.data_ptr(), out.data_ptr(), V, E)
    return out
