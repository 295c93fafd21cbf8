"""Plain PyTorch version of the fixed-order f64 pull sum
(``csrc/pull_contrib.cu``): the products of the sorted slots, added into
their dst with ``index_add_``.  On the CPU ``index_add_`` walks the slots
in order, so each vertex's terms are added one at a time in slot order
from +0.0: the kernel's contract, bit for bit.  On a CUDA device
``index_add_`` adds with atomics, in an order that changes from run to
run; there it agrees with the kernel to f64 summation-order error only.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class PullOrder(NamedTuple):
    """A graph's edge slots sorted once by dst (stable; live slots first),
    fixed for one solve."""

    ptr: torch.Tensor   # int32[V + 1]: vertex v's live slots are
                        # [ptr[v], ptr[v + 1]) of the sorted order
    src: torch.Tensor   # int32[E_cap]: source of each sorted slot


def pull_order(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
               in_deg: torch.Tensor) -> PullOrder:
    """The sorted slots of an edge list with ``in_deg[v]`` live in-edges
    of each vertex: one stable sort, live slots by dst, dead ones last."""
    V = in_deg.shape[0]
    key = torch.where(valid, dst, torch.full_like(dst, V))
    order = torch.argsort(key, stable=True)
    ptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dst.device),
                     torch.cumsum(in_deg.to(torch.int64), 0)])
    return PullOrder(ptr=ptr.to(torch.int32), src=src[order])


def slot_vertex(ptr: torch.Tensor, num_slots: int) -> torch.Tensor:
    """int64[num_slots]: the vertex whose segment [ptr[v], ptr[v + 1])
    holds each sorted slot; V for a slot in no segment."""
    V = ptr.shape[0] - 1
    slot = torch.arange(num_slots, device=ptr.device)
    v = torch.searchsorted(ptr.long(), slot, right=True) - 1
    return torch.where((v >= 0) & (v < V), v, V)


def pull_contrib_ref(order: PullOrder, ranks: torch.Tensor,
                     inv_deg: torch.Tensor) -> torch.Tensor:
    """f64[V]: c[v] = sum of ranks[u] * inv_deg[u] over the slots of v's
    segment (its live in-edges (u, v)), in slot order."""
    V = ranks.shape[0]
    src = order.src.long()
    w = ranks[src] * inv_deg[src]
    out = torch.zeros(V + 1, dtype=ranks.dtype, device=ranks.device)
    return out.index_add_(0, slot_vertex(order.ptr, src.shape[0]), w)[:V]
