"""The work of one launch of each hand-written kernel, and the dry-run's
tally of the launches it stands in for.

Each ``*_work`` function gives ``(ops, bytes)`` of one launch from the
counts that set them: each input byte the call needs read once, each
output byte written once, and an operation for each add (or compare) the
kernel makes.  ``chip_smoke.py`` prices its bounds with them from the
counts its run reads back (live slots, distinct sources, active
windows): these formulas are the smoke's yardstick, so an edit to one
moves the bound that every later run prints for its kernel, and is a
change of the yardstick to be declared as such, never a gain.  On a
``meta`` tensor a wrapper runs its launch path up to the
launch, with every output and scratch buffer allocated as the launch
allocates it, and then ``record``s the work the shapes allow at most
(every slot live, every source distinct up to the sources there are)
instead of launching: ``launch.dryrun`` adds ``WORK`` to the products it
counts.  A meta call counts no launch.
"""
from __future__ import annotations

import collections

__all__ = ["WORK", "record", "reset", "pull_contrib_work", "pull_rows_work",
           "slot_count_work", "segment_bounds_work", "segment_or_work",
           "frontier_spmv_work", "gated_spmm_work", "walk_repair_work"]

# "flops" (float adds and multiplies), "int_ops", "bytes", and the meta
# calls of each kernel by name
WORK: collections.Counter = collections.Counter()


def reset() -> None:
    WORK.clear()


def record(kernel: str, ops: float, nbytes: float, *,
           integer: bool = False) -> None:
    """Tally one meta call of ``kernel``: its ops (float ones, or integer
    ones with ``integer``) and bytes."""
    WORK["int_ops" if integer else "flops"] += ops
    WORK["bytes"] += nbytes
    WORK[kernel] += 1


def pull_contrib_work(V: int, n_live: int, n_src: int,
                      weighted: bool = False):
    """One f64 pull sum: ptr, the live slots' src (and weights), ranks and
    inv_deg once a distinct source, the f64[V] output; a multiply and an
    add a live slot (and a multiply more with weights)."""
    nbytes = (4 * (V + 1) + (12 if weighted else 4) * n_live + 16 * n_src
              + 8 * V)
    return (3 if weighted else 2) * n_live, nbytes


def pull_rows_work(V: int, n_live: int, n_src: int, d: int):
    """One row sum: ptr and the live slots' src once, each distinct source
    row of x once, the f32 [V, d] output; an add a live slot and
    column."""
    return d * n_live, 4 * (V + 1) + 4 * n_live + 4 * d * n_src + 4 * d * V


def slot_count_work(E: int, n: int, n_counted: int, index_bytes: int,
                    gather_bytes: int = 0, gathered: bool = False):
    """One edge-slot count: every slot's bool weight once, the int32 index
    of a counted slot (``index_bytes``: its 32-byte sectors), with a
    gather the gather index of a live slot (``gather_bytes``) and the
    bool flags once, the int32[n] output; an add a counted slot."""
    nbytes = E + index_bytes + gather_bytes + (n if gathered else 0) + 4 * n
    return n_counted, nbytes


def segment_bounds_work(n_live: int, n: int):
    """One ``segment_bounds``: the live sorted int32 keys once, the int32
    ptr[n + 1] once; a compare a live key."""
    return n_live, 4 * n_live + 4 * (n + 1)


def segment_or_work(n_live: int, n: int, src_bytes: int, dst_bytes: int):
    """One ``segment_or``, the lesser of its two routes' bytes: the int32
    src of every live slot (``src_bytes``, its sectors), the bool flags
    and the bool output once, and the sorted dst of each live slot whose
    flag is set (``dst_bytes``) or the int32 ptr[n + 1]; a test a live
    slot."""
    nbytes = min(src_bytes + dst_bytes + 2 * n, src_bytes + 4 * (n + 1)
                 + 2 * n)
    return n_live, nbytes


def frontier_spmv_work(ne: int, be: int, nw: int, vb: int, n_act: int,
                       n_live: int, n_src: int, rsc_item: int):
    """One gated SpMV: valid of every lane of an active entry, src and
    dst_rel of a live lane, window and active_window once, an rsc entry a
    distinct source, the f32 [nw·vb] output; a multiply and an add a live
    lane."""
    nbytes = (4 * be * n_act + 8 * n_live + 4 * ne + nw
              + rsc_item * n_src + 4 * nw * vb)
    return 2 * n_live, nbytes


def gated_spmm_work(be: int, nw: int, n: int, d: int, n_act: int,
                    n_live: int, n_src: int):
    """One gated segment-SpMM: src/dst_rel of a live lane of an active
    entry, valid of every lane of one, a row of d f32 a distinct source,
    entry_start and active_window once, the f32 [n, d] output; a scale
    and an add a live lane and column."""
    nbytes = (8 * n_live + 4 * be * n_act + 4 * d * n_src
              + 4 * (nw + 1) + nw + 4 * d * n)
    return 2 * d * n_live, nbytes


# integer operations of one threefry2x32 call and the draw made from it:
# 20 rounds of add, rotate, xor, 5 two-add key injections, the two key
# adds and the parity word (74), then xor, shift, or and subtract
THREEFRY_OPS = 80


def walk_repair_work(C: int, L: int, kept: int, n_cur: int, n_idx: int,
                     calls: int):
    """One walk repair: the ``kept`` prefix slots of rows, t0 and the
    walk ids, deg and indptr of each distinct vertex a hop leaves, an
    indices entry a distinct edge taken, the int32 [C, L] output;
    ``THREEFRY_OPS`` integer operations a threefry call."""
    nbytes = 4 * kept + 4 * C + 8 * C + 8 * n_cur + 4 * n_idx + 4 * C * L
    return THREEFRY_OPS * calls, nbytes
