"""Plain PyTorch versions of the fixed-order pull sums
(``csrc/pull_contrib.cu``).

The contract of both: vertex v's segment [ptr[v], ptr[v + 1]) of sorted
slots is cut into chunks of at most K slots (``PULL_CHUNK`` for the f64
sums, ``ROW_CHUNK`` for the row sums); each chunk's terms are added in
slot order from +0.0, and a vertex's chunk sums are then added to its
first chunk's sum in chunk order.  A segment of at most K slots is one
chunk, its terms added one at a time from +0.0.

The plain versions add each slot's term into its chunk's row with
``index_add_`` (on the CPU it walks the slots in order), then each split
vertex's chunk rows into its first with a second ``index_add_`` (in chunk
order): the kernels' contract, bit for bit.  On a CUDA device
``index_add_`` adds with atomics, in an order that changes from run to
run; there it agrees with the kernels to summation-order error only.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

# slots of one vertex a thread of the f64 sum walks at most: the smoke
# graph's hub (62,458 in-edges) is 244 chunks
PULL_CHUNK = 256
# slots of one vertex a warp of the row sum walks at most: the smoke
# graph's hub is 976 chunks
ROW_CHUNK = 64
# sorted slots whose rows the plain row sum gathers at once: 5 GB of f32
# rows at D = 602, under 2**31 elements (torch's 32-bit index math)
EDGE_CHUNK = 1 << 21


class PullOrder(NamedTuple):
    """A graph's edge slots sorted once by dst (stable; live slots first;
    ``pull_contrib.pull_order``)."""

    ptr: torch.Tensor   # int32[V + 1]: vertex v's live slots are
                        # [ptr[v], ptr[v + 1]) of the sorted order
    src: torch.Tensor   # int32[E_cap]: source of each sorted slot
    # int32[E_cap]: the sort's keys, the dst of each sorted slot (V for a
    # dead one); None for an order built without a sort (``segment_sum``)
    dst: Optional[torch.Tensor] = None


def slot_vertex(ptr: torch.Tensor, num_slots: int) -> torch.Tensor:
    """int64[num_slots]: the vertex whose segment [ptr[v], ptr[v + 1])
    holds each sorted slot; V for a slot in no segment."""
    V = ptr.shape[0] - 1
    slot = torch.arange(num_slots, device=ptr.device)
    v = torch.searchsorted(ptr.long(), slot, right=True) - 1
    return torch.where((v >= 0) & (v < V), v, V)


def chunk_rows(ptr: torch.Tensor, chunk_slots: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row int64[live slots], owner int64[P]) for the chunked sums: the
    row each live sorted slot's term is summed into (its vertex v for the
    first chunk of v's segment, V + p for the p-th partial: chunks 1.. of
    each vertex, in vertex then chunk order) and the vertex each partial
    belongs to.  Reads the live and partial counts back to the host."""
    V = ptr.shape[0] - 1
    start = ptr.long()
    parts = torch.clamp((start[1:] - start[:-1] + chunk_slots - 1)
                        // chunk_slots, min=1) - 1   # chunks after the first
    part0 = torch.cumsum(parts, 0) - parts
    k = torch.arange(int(start[-1]), device=ptr.device)
    v = torch.searchsorted(start, k, right=True) - 1
    j = (k - start[v]) // chunk_slots
    row = torch.where(j == 0, v, V + part0[v] + j - 1)
    owner = torch.repeat_interleave(torch.arange(V, device=ptr.device),
                                    parts)
    return row, owner


def pull_contrib_ref(order: PullOrder, ranks: torch.Tensor,
                     inv_deg: torch.Tensor,
                     weight: Optional[torch.Tensor] = None,
                     chunk_slots: int = PULL_CHUNK) -> torch.Tensor:
    """f64[V]: c[v] = the sum of ranks[u] * inv_deg[u] (u = src[k]), or
    with a per-slot ``weight`` of (ranks[u] * weight[k]) * inv_deg[u],
    over the slots k of v's segment, cut as the kernel cuts it: chunks of
    at most ``chunk_slots`` slots, each summed in slot order from +0.0,
    then a vertex's chunk sums added in chunk order to its first."""
    V = order.ptr.shape[0] - 1
    row, owner = chunk_rows(order.ptr, chunk_slots)
    live = row.shape[0]
    src = order.src[:live].long()
    w = (ranks[src] * inv_deg[src] if weight is None
         else ranks[src] * weight[:live] * inv_deg[src])
    buf = torch.zeros(V + owner.shape[0], dtype=ranks.dtype,
                      device=ranks.device).index_add_(0, row, w)
    out = buf[:V]
    return out.index_add_(0, owner, buf[V:])


def pull_rows_ref(order: PullOrder, x: torch.Tensor,
                  chunk_slots: int = ROW_CHUNK,
                  slots_at_once: Optional[int] = None) -> torch.Tensor:
    """f32[V, D] (f64 for f64 rows): out[v] = the sum of the rows
    x[src[k]] over v's segment, cut as the kernel cuts it: chunks of at
    most ``chunk_slots`` slots, each summed in slot order from +0.0, then
    a vertex's chunk sums added in chunk order to its first.  The gathered
    rows are taken ``slots_at_once`` (default ``EDGE_CHUNK``) slots at a
    time."""
    if slots_at_once is None:
        slots_at_once = EDGE_CHUNK
    V, d = order.ptr.shape[0] - 1, x.shape[1]
    # f32 sums (the kernel's); f64 rows stay f64 (gradient checks)
    dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    row, owner = chunk_rows(order.ptr, chunk_slots)
    buf = torch.zeros(V + owner.shape[0], d, dtype=dtype, device=x.device)
    for s in range(0, row.shape[0], slots_at_once):
        e = min(s + slots_at_once, row.shape[0])
        buf.index_add_(0, row[s:e], x[order.src[s:e].long()].to(dtype))
    out = buf[:V]
    return out.index_add_(0, owner, buf[V:])
