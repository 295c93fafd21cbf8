"""Plain PyTorch versions of the fixed-order pull sums
(``csrc/pull_contrib.cu``): the terms of the sorted slots, added into
their segment with ``index_add_``.  On the CPU ``index_add_`` walks the
slots in order, so each segment's terms are added one at a time in slot
order from +0.0: the kernels' contract, bit for bit.  On a CUDA device
``index_add_`` adds with atomics, in an order that changes from run to
run; there it agrees with the kernels to summation-order error only.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

# slots of one vertex a warp of the row sum walks at most: the smoke
# graph's hub (62,458 in-edges) is 976 chunks
ROW_CHUNK = 64
# sorted slots whose rows the plain row sum gathers at once: 5 GB of f32
# rows at D = 602, under 2**31 elements (torch's 32-bit index math)
EDGE_CHUNK = 1 << 21


class PullOrder(NamedTuple):
    """A graph's edge slots sorted once by dst (stable; live slots first),
    fixed for one solve."""

    ptr: torch.Tensor   # int32[V + 1]: vertex v's live slots are
                        # [ptr[v], ptr[v + 1]) of the sorted order
    src: torch.Tensor   # int32[E_cap]: source of each sorted slot


def sorted_slots(key: torch.Tensor, valid: torch.Tensor,
                 counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ptr int32[V + 1], perm int64[E]) for slots keyed by ``key`` with
    ``counts[v]`` live slots of each key v: one stable sort, live slots by
    key, dead ones last; segment v is ``perm[ptr[v]:ptr[v + 1]]``."""
    V = counts.shape[0]
    k = torch.where(valid, key, torch.full_like(key, V))
    perm = torch.argsort(k, stable=True)
    ptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=key.device),
                     torch.cumsum(counts.to(torch.int64), 0)])
    return ptr.to(torch.int32), perm


def pull_order(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
               in_deg: torch.Tensor) -> PullOrder:
    """The sorted slots of an edge list with ``in_deg[v]`` live in-edges
    of each vertex: one stable sort, live slots by dst, dead ones last."""
    ptr, perm = sorted_slots(dst, valid, in_deg)
    return PullOrder(ptr=ptr, src=src[perm])


def slot_vertex(ptr: torch.Tensor, num_slots: int) -> torch.Tensor:
    """int64[num_slots]: the vertex whose segment [ptr[v], ptr[v + 1])
    holds each sorted slot; V for a slot in no segment."""
    V = ptr.shape[0] - 1
    slot = torch.arange(num_slots, device=ptr.device)
    v = torch.searchsorted(ptr.long(), slot, right=True) - 1
    return torch.where((v >= 0) & (v < V), v, V)


def pull_contrib_ref(order: PullOrder, ranks: torch.Tensor,
                     inv_deg: torch.Tensor,
                     weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f64[V]: c[v] = sum over the slots k of v's segment, in slot order,
    of ranks[u] * inv_deg[u] (u = src[k]), or with a per-slot ``weight``
    of (ranks[u] * weight[k]) * inv_deg[u]."""
    V = order.ptr.shape[0] - 1
    src = order.src.long()
    w = (ranks[src] * inv_deg[src] if weight is None
         else ranks[src] * weight * inv_deg[src])
    out = torch.zeros(V + 1, dtype=ranks.dtype, device=ranks.device)
    return out.index_add_(0, slot_vertex(order.ptr, src.shape[0]), w)[:V]


def pull_rows_ref(order: PullOrder, x: torch.Tensor,
                  chunk_slots: int = ROW_CHUNK,
                  slots_at_once: Optional[int] = None) -> torch.Tensor:
    """f32[V, D]: out[v] = the sum of the rows x[src[k]] over v's segment,
    cut as the kernel cuts it: chunks of at most ``chunk_slots`` slots,
    each summed in slot order from +0.0, then a vertex's chunk sums added
    in chunk order to its first.  The gathered rows are taken
    ``slots_at_once`` (default ``EDGE_CHUNK``) slots at a time."""
    if slots_at_once is None:
        slots_at_once = EDGE_CHUNK
    V, d = order.ptr.shape[0] - 1, x.shape[1]
    ptr = order.ptr.long()
    parts = torch.clamp((ptr[1:] - ptr[:-1] + chunk_slots - 1)
                        // chunk_slots, min=1) - 1   # chunks after the first
    part0 = torch.cumsum(parts, 0) - parts
    n_live, n_parts = int(ptr[-1]), int(parts.sum())
    buf = torch.zeros(V + n_parts, d, dtype=torch.float32, device=x.device)
    for s in range(0, n_live, slots_at_once):
        k = torch.arange(s, min(s + slots_at_once, n_live), device=x.device)
        v = torch.searchsorted(ptr, k, right=True) - 1
        j = (k - ptr[v]) // chunk_slots
        row = torch.where(j == 0, v, V + part0[v] + j - 1)
        buf.index_add_(0, row, x[order.src[k].long()].to(torch.float32))
    out = buf[:V]
    owner = torch.repeat_interleave(torch.arange(V, device=x.device), parts)
    return out.index_add_(0, owner, buf[V:])
