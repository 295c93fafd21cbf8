"""The chunk plan of the gated segment-SpMM: windows cut into chunks of at
most ``k`` entries, so that no block of the kernel walks more than ``k``
entries however many one window owns.

Window ``w`` owns the entries ``[entry_start[w], entry_start[w+1])`` and
``entry_start`` never changes after packing, so the plan is a function of
``entry_start`` and ``k`` alone.  It is built on ``entry_start``'s device
with no host read: its lengths are bounds that follow from the shapes, and
the slots past the real count are marked surplus (window ``nw``).

    chunks    C = nw + ne // k       window w gets max(1, ceil(n_w / k))
    partials  P = ne // k            chunks 1.. of a split window
    splits    S = min(nw, ne // (k + 1))   windows of more than k entries

(``ne`` = ``entry_start[nw]``, the entry capacity.)  Chunk 0 of a window
writes its rows to the output; chunk j >= 1 of a split window writes a
partial tile to slot ``part``.  A second pass then adds a split window's
partials to its rows in chunk order, so every sum has one fixed order.
An empty window is one chunk of no entry: it writes zeros.

``entry_start`` never changes after packing (``apply_batch_packed`` carries
the same tensor on), so ``cached_plan`` builds a plan once per packed
structure and K, and hands the same one back on every later call.

``live_chunk_plan`` is the same plan for segments that are mostly empty
(the row sum's, ``pull_contrib.pull_rows``: a table gradient sums 2.6 M
ids into 39 M rows).  It lists only the chunks of non-empty segments, cut
from each segment's first slot as ``chunk_plan`` cuts them, and numbers
the partials as ``chunk_plan`` does (and ``pull_contrib.ref.chunk_rows``);
the empty segments get no chunk (the row kernel fills their rows with
zeros from ``ptr``).  Where the slots are fewer than the segments it is
built from the sorted slots' keys, one pass over the slots and one gather
of ``ptr`` at each of them: its work and memory are then O(ne), not O(nw)
(a table gradient); else over the segments as ``chunk_plan`` is (a graph,
whose slots outnumber its vertices).  Its bounds are

    chunks    C = min(nw, ne) + ne // k
    partials  P = ne // k
    splits    S = min(nw, ne // (k + 1))
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, \
    TypeVar, Union

import torch

T = TypeVar("T")


class ChunkPlan(NamedTuple):
    window: torch.Tensor        # int32[C]  window of the chunk; nw: surplus
    begin: torch.Tensor         # int32[C]  first entry
    end: torch.Tensor           # int32[C]  one past the last entry
    part: torch.Tensor          # int32[C]  partial slot; -1: writes out
    split_window: torch.Tensor  # int32[S]  s-th split window; nw: surplus
    split_part: torch.Tensor    # int32[S]  its first partial slot
    split_count: torch.Tensor   # int32[S]  its partials (chunks - 1)
    num_partials: int           # P: partial tiles the scratch holds


def plan_sizes(nw: int, ne: int, k: int) -> tuple:
    """(C, P, S): the plan's chunk, partial and split-window bounds."""
    return nw + ne // k, ne // k, min(nw, ne // (k + 1))


def chunk_plan(entry_start: torch.Tensor, ne: int, k: int) -> ChunkPlan:
    """The plan for windows owning ``[entry_start[w], entry_start[w+1])``
    (int32[NW+1], ``entry_start[NW] == ne``), cut into chunks of at most
    ``k`` entries.  No host read: every length is a bound (module doc)."""
    if k < 1:
        raise ValueError(f"chunk_plan: k must be >= 1, got {k}")
    nw = entry_start.shape[0] - 1
    if nw == 0:
        none = torch.zeros(0, dtype=torch.int32, device=entry_start.device)
        return ChunkPlan(none, none, none, none, none, none, none, 0)
    return _by_windows(entry_start, k, plan_sizes(nw, ne, k), 1)


def _by_windows(entry_start: torch.Tensor, k: int, sizes: tuple,
                least: int) -> ChunkPlan:
    """The plan of ``sizes`` (C, P, S), built over the windows: window w
    gets max(least, ceil(n_w / k)) chunks, found by a search of each chunk
    slot in the windows' running chunk counts.  O(NW + C log NW)."""
    nw = entry_start.shape[0] - 1
    n_chunks, n_parts, n_splits = sizes
    dev = entry_start.device
    if nw == 0:
        return ChunkPlan(*(torch.full((n,), nw, dtype=torch.int32,
                                      device=dev)
                           for n in (n_chunks,) * 4 + (n_splits,) * 3),
                         num_partials=n_parts)
    start = entry_start.long()
    owned = start[1:] - start[:-1]
    per_window = torch.clamp((owned + k - 1) // k, min=least)
    last = torch.cumsum(per_window, 0)            # one past each window's
    c = torch.arange(n_chunks, device=dev)
    w = torch.searchsorted(last, c, right=True)   # nw for surplus slots
    wc = torch.clamp(w, max=nw - 1)
    j = c - (last - per_window)[wc]               # chunk within its window
    begin = start[wc] + j * k
    end = torch.minimum(begin + k, start[wc + 1])
    # partial slots: chunks 1.. of each window, in window then chunk order
    parts = torch.clamp(per_window - 1, min=0)
    part0 = torch.cumsum(parts, 0) - parts
    part = torch.where(j > 0, part0[wc] + j - 1, torch.full_like(j, -1))
    s = torch.arange(n_splits, device=dev)
    sw = torch.searchsorted(torch.cumsum((parts > 0).long(), 0), s,
                            right=True)
    swc = torch.clamp(sw, max=nw - 1)

    def i32(t, keep):
        return torch.where(keep, t, torch.full_like(t, nw)).to(torch.int32)

    return ChunkPlan(
        window=i32(w, w < nw), begin=i32(begin, w < nw),
        end=i32(end, w < nw), part=i32(part, w < nw),
        split_window=i32(sw, sw < nw), split_part=i32(part0[swc], sw < nw),
        split_count=i32(parts[swc], sw < nw), num_partials=n_parts)


def live_plan_sizes(nw: int, ne: int, k: int) -> tuple:
    """(C, P, S): ``live_chunk_plan``'s chunk, partial and split bounds."""
    return min(nw, ne) + ne // k, ne // k, min(nw, ne // (k + 1))


def live_chunk_plan(ptr: torch.Tensor, keys: Optional[torch.Tensor],
                    ne: int, k: int) -> ChunkPlan:
    """The plan of the non-empty segments ``[ptr[w], ptr[w+1])``
    (int32[NW+1], ``ptr[NW]`` <= ``ne``) of ``ne`` sorted slots, cut into
    chunks of at most ``k`` slots; ``keys`` (int[ne]) holds each slot's
    segment, NW for a slot past ``ptr[NW]`` (``PullOrder.dst``), or is
    None.  Built over the slots where there are fewer slots than segments
    and the keys are given (O(ne)), else over the segments as
    ``chunk_plan`` builds (O(NW + C log NW)): the same plan either way.  No
    host read: every length is a bound (module doc); surplus slots hold
    NW."""
    if k < 1:
        raise ValueError(f"live_chunk_plan: k must be >= 1, got {k}")
    nw = ptr.shape[0] - 1
    sizes = live_plan_sizes(nw, ne, k)
    if keys is None or nw <= ne:
        return _by_windows(ptr, k, sizes, 0)
    return _by_slots(ptr, keys, ne, k, sizes)


# slots of the plan's arrays that the slots starting no chunk write to, in
# turn: one slot for them all would take every such write at one address
_DUMP = 1024


def _by_slots(ptr: torch.Tensor, keys: torch.Tensor, ne: int, k: int,
              sizes: tuple) -> ChunkPlan:
    """The plan of ``sizes`` (C, P, S), built over the ``ne`` sorted slots
    from their keys: a slot starts a chunk where its offset in its segment
    is a multiple of k, and each chunk's entry goes to its rank among the
    chunk starts.  O(ne), with ``ptr`` read at the slots' keys only."""
    nw = ptr.shape[0] - 1
    n_chunks, n_parts, n_splits = sizes
    dev = ptr.device
    slot = torch.arange(ne, device=dev)
    key = keys[:ne].long()
    # each slot's segment bounds
    kc = torch.clamp(key, max=nw - 1)
    seg_begin = ptr.index_select(0, kc).long()
    seg_end = ptr.index_select(0, kc + 1).long()
    j = torch.div(slot - seg_begin, k, rounding_mode="floor")
    chunk = (key < nw) & (slot - seg_begin == j * k)   # a chunk starts here
    first = chunk & (j == 0)                           # a segment's chunk 0
    c = torch.cumsum(chunk, 0) - 1                     # its chunk
    # chunk c of segment ordinal o is partial c - o - 1 when it is not the
    # segment's first: chunks 1.. of each segment, in segment then chunk
    # order, as chunk_plan numbers them
    part = torch.where(j > 0, c - torch.cumsum(first, 0), -1)
    # the split segments: those with a chunk 1, in segment order
    second = chunk & (j == 1)
    dump = torch.remainder(slot, _DUMP)

    def compact(at, size, value):
        """int32[size]: ``value[i]`` at ``at[i]``, NW where no slot lands
        (a slot that lands nowhere writes a dump slot past ``size``)."""
        out = torch.full((size + _DUMP,), nw, dtype=torch.int32, device=dev)
        return out.index_copy_(0, at, value.to(torch.int32))[:size]

    at = torch.where(chunk, c, n_chunks + dump)
    at_split = torch.where(second, torch.cumsum(second, 0) - 1,
                           n_splits + dump)
    count = torch.div(seg_end - seg_begin + k - 1, k,
                      rounding_mode="floor") - 1
    return ChunkPlan(
        window=compact(at, n_chunks, key), begin=compact(at, n_chunks, slot),
        end=compact(at, n_chunks, torch.minimum(slot + k, seg_end)),
        part=compact(at, n_chunks, part),
        split_window=compact(at_split, n_splits, key),
        split_part=compact(at_split, n_splits, part),
        split_count=compact(at_split, n_splits, count),
        num_partials=n_parts)


# id(tensor), or the ids of a tuple of tensors -> (weak references to
# them, {key: value}): the plans, and what else is built once per tensor
# (the row sum's hot set) or per tuple of tensors (a graph's pull order);
# an entry goes when any of its tensors is freed, so a freed tensor's
# address cannot reach a stale value.  Two threads use the table (the
# serve step and the shadow verifier's, obs/shadow.py), so every look-up,
# insertion and removal holds _LOCK; it is re-entrant because a build may
# free a tensor, whose weak reference then removes its entry
_PLANS: Dict[Any, Tuple[Tuple[weakref.ref, ...], Dict[Any, Any]]] = {}
_LOCK = threading.RLock()


def _forget(slot, ref: weakref.ref) -> None:
    with _LOCK:
        hit = _PLANS.get(slot)
        if hit is not None and any(r is ref for r in hit[0]):
            del _PLANS[slot]


def cached(tensors: Union[torch.Tensor, Tuple[torch.Tensor, ...]], key,
           build: Callable[[], T]) -> T:
    """``build()``, called at the first call on this tensor (or tuple of
    tensors) with this ``key`` and then handed back as is.  The value is
    dropped when any of the tensors is freed (a repack or a new order
    makes a new one)."""
    if isinstance(tensors, torch.Tensor):
        tensors = (tensors,)
    ids = tuple(id(t) for t in tensors)
    slot = ids[0] if len(ids) == 1 else ids
    with _LOCK:
        hit = _PLANS.get(slot)
        if hit is None or any(r() is not t
                              for r, t in zip(hit[0], tensors)):
            refs = tuple(weakref.ref(t, lambda r, slot=slot: _forget(slot, r))
                         for t in tensors)
            hit = _PLANS[slot] = (refs, {})
        values = hit[1]
        if key not in values:
            values[key] = build()
        return values[key]


def cached_plan(entry_start: torch.Tensor, ne: int, k: int) -> ChunkPlan:
    """``chunk_plan(entry_start, ne, k)``, built at the first call on this
    ``entry_start`` tensor and then handed back as is: no launch and no
    host read."""
    return cached(entry_start, (ne, k),
                  lambda: chunk_plan(entry_start, ne, k))


def cached_live_plan(ptr: torch.Tensor, keys: Optional[torch.Tensor],
                     ne: int, k: int) -> ChunkPlan:
    """``live_chunk_plan(ptr, keys, ne, k)``, built at the first call on
    these tensors and then handed back as is."""
    return cached(ptr if keys is None else (ptr, keys), ("live", ne, k),
                  lambda: live_chunk_plan(ptr, keys, ne, k))
