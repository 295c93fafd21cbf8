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
over a chunk plan of ``segment_ops.plan`` (built on the device at the
first call on an order and cached with it).  ``pull_contrib``'s plan
(``chunk_plan``) has a chunk for every vertex; ``pull_rows``' plan
(``row_plan``: ``live_chunk_plan``) only the chunks of non-empty
segments, in O(slots) where the slots are fewer than the rows, and the
kernel writes the zero rows of the empty ones in one coalesced pass over
``ptr``, so that a sum of few slots into many rows (DeepFM's table
gradients: 2.6 M ids into 39 M rows) costs what its slots and its
output's bytes cost.  ``pull_rows`` walks a chunk with a warp where a row
is wide and with a group of ``row_lanes`` lanes where it is narrow (32
chunks a warp at d = 1); narrow rows into more rows than slots are
staged a row a slot and placed by the fill, so that every row of the
output is written whole, once.  It keeps the rows of the sources with
the most live slots (``HOT_BYTES`` of them, ``hot_set``, cached with the
plan; the kernel tags their slots, ``tag_slots``) in the card's L2 and
reads each row in one pass of float2 or float4 loads where d and x's
address allow (``row_path``).  On a ``meta`` tensor they run the launch
path with no launch (``kernels.work``).  A failed build or launch
raises.  ``LAUNCH_COUNTS`` counts calls that launch each kernel,
``ROW_WIDTH_LAUNCHES`` the ``pull_rows`` launches by row width.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import work
from repro_torch.kernels.build import check_arg
from repro_torch.kernels.pull_contrib.ref import PULL_CHUNK, ROW_CHUNK, \
    PullOrder, pull_contrib_ref, pull_rows_ref
from repro_torch.kernels.segment_ops.plan import ChunkPlan, cached, \
    cached_live_plan, cached_plan
from repro_torch.kernels.slot_count.slot_count import segment_bounds, \
    slot_count

__all__ = ["HOT_BYTES", "HOT_TAG", "HotSet", "LAUNCH_COUNTS",
           "PACKED_LANES", "PULL_CHUNK", "PullOrder", "ROW_CHUNK",
           "ROW_PATHS", "ROW_WIDTH_LAUNCHES", "cached_hot_set", "hot_set",
           "kernel_info", "pull_contrib", "pull_order", "pull_rows",
           "pull_values", "row_lanes", "row_path", "row_plan",
           "segment_sum", "sorted_slots", "source_ranking", "tag_slots"]

LAUNCH_COUNTS: collections.Counter = collections.Counter()
# pull_rows launches by row width d
ROW_WIDTH_LAUNCHES: collections.Counter = collections.Counter()

_check = functools.partial(check_arg, "pull_contrib")
_check_rows = functools.partial(check_arg, "pull_rows")


def sorted_slots(key: torch.Tensor, valid: torch.Tensor, n: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ptr int32[n + 1], perm int64[E], keys int32[E]) for the slots keyed
    by ``key`` (int32, each live one in [0, n)) sorted once, stably: live
    slots by key, dead ones (keyed n) last; segment v is
    ``perm[ptr[v]:ptr[v + 1]]`` and ``keys`` the sorted keys.  The sort
    returns the keys with the permutation, and ``segment_bounds`` writes
    each segment from them: no count first, no atomic, no host read."""
    k = torch.where(valid, key, torch.full_like(key, n))
    keys, perm = torch.sort(k, stable=True)
    return segment_bounds(keys, n), perm, keys


def pull_order(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
               n: int) -> PullOrder:
    """The sorted slots of an edge list of ``n`` vertices: one stable sort,
    live slots by dst, dead ones last; the order keeps the sorted dst."""
    ptr, perm, keys = sorted_slots(dst, valid, n)
    return PullOrder(ptr=ptr, src=src[perm], dst=keys)


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
                                     + [ctypes.c_int] + [ctypes.c_void_p] * 2
                                     + [ctypes.c_int] + [ctypes.c_void_p] * 3
                                     + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.pull_rows_launch.restype = ctypes.c_int
    lib.pull_rows_info.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.pull_rows_info.restype = ctypes.c_int
    lib.pull_contrib_info.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.pull_contrib_info.restype = ctypes.c_int
    return lib


def kernel_info(device=None) -> dict:
    """Registers a thread, resident blocks a SM, the SMs and threads a
    block of the f64 chunk kernel on the card; registers and blocks a SM
    of the scalar row kernel, the weighted chunk kernel and the split
    kernel; ``row_paths``: {"<floats a load>x<loads a lane>": (registers,
    blocks a SM)} of every row path (a warp a chunk), and
    ``packed_paths``: {"<floats a load>/<lanes a chunk>": (registers,
    blocks a SM)} of every packed path (narrow rows, ``row_lanes``)."""
    index = None if device is None else torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    info = (ctypes.c_int * 10)()
    rc = _lib().pull_contrib_info(index, ctypes.addressof(info))
    if rc != 0:
        raise RuntimeError(f"pull_contrib_info failed: CUDA error {rc}")
    def row_info(vec, loads, group):
        row = (ctypes.c_int * 2)()
        rc = _lib().pull_rows_info(index, vec, loads, group,
                                   ctypes.addressof(row))
        if rc != 0:
            raise RuntimeError(f"pull_rows_info failed: CUDA error {rc}")
        return row[0], row[1]
    paths = {f"{vec}x{loads}": row_info(vec, loads, WARP)
             for vec, loads in ROW_PATHS.items()}
    packed = {f"{vec}/{g}": row_info(vec, loads, g)
              for vec, loads in ROW_PATHS.items() for g in PACKED_LANES}
    return dict(registers=info[0], blocks_per_sm=info[1], sms=info[2],
                threads_per_block=info[3], row_registers=info[4],
                row_blocks_per_sm=info[5], weighted_registers=info[6],
                weighted_blocks_per_sm=info[7], split_registers=info[8],
                split_blocks_per_sm=info[9], row_paths=paths,
                packed_paths=packed)


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
    if dev.type == "meta":                 # the dry-run: no launch
        work.record("pull_contrib", *work.pull_contrib_work(
            V, E, min(N, E), weight is not None))
        return out
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
    if ranks.device.type not in ("cuda", "meta"):
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


# bytes of source rows the row sum keeps in L2 (the hot set's budget)
HOT_BYTES = 30_000_000
# the sign bit of a sorted slot's src: its source is hot
HOT_TAG = -2**31
# the row kernel's paths (csrc/pull_contrib.cu PULL_ROWS_PATHS): floats a
# load -> loads a lane a pass (a pass of 32 lanes covers 128, 640 or 256
# columns: d = 128 and 602 in one pass)
ROW_PATHS = {4: 1, 2: 10, 1: 8}
# lanes a chunk of the packed row paths (csrc/pull_contrib.cu
# PULL_ROWS_PACKED_PATHS), and of the wide one: a warp
PACKED_LANES = (1, 2, 4, 8, 16)
WARP = 32


def row_path(d: int, data_ptr: int) -> Tuple[int, int]:
    """(floats a load, loads a lane a pass) of the row kernel for rows of
    ``d`` f32 from address ``data_ptr``: float4, else float2 loads where
    ``d`` and the address allow them, else scalar loads."""
    vec = next(v for v in (4, 2, 1)
               if d % v == 0 and data_ptr % (4 * v) == 0)
    return vec, ROW_PATHS[vec]


def row_lanes(d: int, vec: int) -> int:
    """Lanes a chunk for rows of ``d`` f32 read ``vec`` floats a load: the
    row's vectors rounded up to a power of two where they fill at most
    half a warp (so a warp walks 32 / lanes chunks), else a warp."""
    return next((g for g in PACKED_LANES if d // vec <= g), WARP)


class HotSet(NamedTuple):
    """The sources whose rows the row sum keeps in L2."""

    tag: torch.Tensor   # int32[n]: HOT_TAG for a hot source, else 0
    hot: torch.Tensor   # bool[n]: the hot sources
    top: torch.Tensor   # int64[H]: the sources ranked first (the hot ones
                        # and any of no live slot), most live slots first


def source_ranking(order: PullOrder, n: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(count int32[n], rank int64[n]): each of the ``n`` sources' live
    slots in ``order`` (``slot_count`` over the live sorted src), and the
    sources by count, most first, ties by the lower id (a stable sort)."""
    E = order.src.shape[0]
    live = torch.arange(E, dtype=torch.int32,
                        device=order.src.device) < order.ptr[-1]
    count = slot_count(torch.where(live, order.src, 0), live, n)
    return count, torch.sort(count, descending=True, stable=True).indices


def hot_set(order: PullOrder, n: int, rows: int,
            ranking: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
            ) -> HotSet:
    """The hot set of at most ``rows`` sources of ``n``: those ranked first
    by ``source_ranking`` (``ranking``, built here if not given) that have
    a live slot.  No host read, and nothing the size of the slots."""
    dev = order.src.device
    if rows <= 0 or n == 0:
        return HotSet(torch.zeros(0, dtype=torch.int32, device=dev),
                      torch.zeros(n, dtype=torch.bool, device=dev),
                      torch.zeros(0, dtype=torch.int64, device=dev))
    count, rank = source_ranking(order, n) if ranking is None else ranking
    top = rank[:rows]
    hot = torch.zeros(n, dtype=torch.bool, device=dev).scatter_(
        0, top, count[top] > 0)
    return HotSet(torch.where(hot, HOT_TAG, 0).to(torch.int32), hot, top)


def tag_slots(order: PullOrder, hot: HotSet) -> torch.Tensor:
    """int32[E]: the order's src with ``HOT_TAG`` set on the live slots of
    hot sources: the plain version of the row kernel's first launch (which
    writes only the live slots)."""
    if hot.top.shape[0] == 0:
        return order.src
    live = torch.arange(order.src.shape[0], dtype=torch.int32,
                        device=order.src.device) < order.ptr[-1]
    idx = torch.where(live, order.src, 0)
    return torch.where(live, order.src | hot.tag.index_select(0, idx),
                       order.src)


def _per_order(order: PullOrder, key: tuple, build):
    """``build()`` once per order, cached on its ``ptr`` and ``src``."""
    return cached((order.ptr, order.src), key, build)


def cached_hot_set(order: PullOrder, n: int, d: int,
                   hot_bytes: int) -> HotSet:
    """The hot set of rows of ``d`` f32 in ``hot_bytes``, built at the
    first call on this order and width: the sources' ranking is built once
    an order, so the layers of a forward (one order, two widths) share
    it."""
    rows = min(n, max(hot_bytes, 0) // (4 * max(d, 1)))
    if rows == 0:
        return hot_set(order, n, 0)
    ranking = _per_order(order, ("source_ranking", n),
                         lambda: source_ranking(order, n))
    return _per_order(order, ("hot_set", n, rows),
                      lambda: hot_set(order, n, rows, ranking))


def row_plan(order: PullOrder, chunk_slots: int) -> ChunkPlan:
    """The row sum's plan of ``order``: the chunks of its non-empty
    segments only (``segment_ops.plan.live_chunk_plan``: over the slots
    from the sorted keys where they are fewer than the rows, else over
    ``ptr``), built at the first call on this order and K and then handed
    back as is."""
    return cached_live_plan(order.ptr, order.dst, order.src.shape[0],
                            chunk_slots)


def _launch_rows(order: PullOrder, x: torch.Tensor, chunk_slots: int,
                 hot_bytes: int) -> torch.Tensor:
    V, E = order.ptr.shape[0] - 1, order.src.shape[0]
    dev = x.device
    n, d = x.shape
    _check_rows("ptr", order.ptr, torch.int32, (V + 1,), dev)
    _check_rows("src", order.src, torch.int32, (E,), dev)
    _check_rows("x", x, torch.float32, (n, d), dev)
    if chunk_slots < 1:
        raise ValueError(f"pull_rows: chunk_slots must be >= 1, got "
                         f"{chunk_slots}")
    if E >= 2**31 - 256:
        raise ValueError(f"pull_rows: {E} edge slots exceed the kernel's "
                         "int32 slot offsets")
    out = torch.empty(V, d, dtype=torch.float32, device=dev)
    if V == 0 or d == 0:
        return out
    plan = row_plan(order, chunk_slots)
    hot = cached_hot_set(order, n, d, hot_bytes)
    # the tagged slots the kernel's first launch writes (live ones only)
    tagged = torch.empty_like(order.src) if hot.top.shape[0] else None
    vec, loads = row_path(d, x.data_ptr())
    lanes = row_lanes(d, vec)
    partial = torch.empty(plan.num_partials * d, dtype=torch.float32,
                          device=dev)
    # narrow rows into more rows than slots: the segments' sums are staged
    # a row a first slot, and the fill writes every row of out (a sector
    # written in parts by two launches costs the memory a read too)
    staged = (torch.empty(E, d, dtype=torch.float32, device=dev)
              if lanes < WARP and E < V else None)
    if dev.type == "meta":                 # the dry-run: no launch
        work.record("pull_rows", *work.pull_rows_work(V, E, min(n, E), d))
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _lib().pull_rows_launch(
            torch.cuda.current_device(),
            *(t.data_ptr() for t in plan[:7]), order.src.data_ptr(),
            None if tagged is None else hot.tag.data_ptr(),
            order.ptr.data_ptr(),
            None if tagged is None else tagged.data_ptr(), E,
            x.data_ptr(), hot.top.data_ptr(), hot.top.shape[0],
            out.data_ptr(), partial.data_ptr(),
            None if staged is None else staged.data_ptr(),
            plan.window.shape[0], plan.split_window.shape[0], V, d, vec,
            loads, lanes, stream)
    if rc != 0:
        raise RuntimeError(f"pull_rows kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCH_COUNTS["pull_rows"] += 1
    ROW_WIDTH_LAUNCHES[d] += 1
    return out


def pull_rows(order: PullOrder, x: torch.Tensor, *,
              chunk_slots: int = ROW_CHUNK,
              hot_bytes: int = HOT_BYTES) -> torch.Tensor:
    """f32[V, D]: out[v] = the sum of the rows x[u] (x: f32[N, D]) over
    v's live in-edges (u, v) of ``order``: each chunk of at most
    ``chunk_slots`` slots summed in slot order from +0.0, then a vertex's
    chunks added in chunk order.  On the card the rows of the sources with
    the most live slots, ``hot_bytes`` of them, are kept in L2 by the
    loads' cache policy (``hot_set``); that changes no sum."""
    if x.dim() != 2:
        raise ValueError(f"pull_rows: x must be [N, D], got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return pull_rows_ref(order, x, chunk_slots)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"pull_rows: no kernel for device {x.device}")
    return _launch_rows(order, x, chunk_slots, hot_bytes)
