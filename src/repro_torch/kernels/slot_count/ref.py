"""Plain PyTorch versions of the edge-slot counts (``csrc/slot_count.cu``):
the int32 ``index_add_`` that ``graph.structure._count`` was, and the
bounds and OR over a sorted slot order.  The counts are integers, so the
kernel's atomics give the same result in any order.
"""
from __future__ import annotations

from typing import Optional

import torch


def slot_count_ref(index: torch.Tensor, weight: torch.Tensor, n: int,
                   gather: Optional[torch.Tensor] = None,
                   flags: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32[n]: the number of slots e with ``weight[e]`` set (and
    ``flags[gather[e]]`` set, when given) whose ``index[e]`` is each
    value."""
    hit = weight if gather is None else weight & flags[gather.long()]
    out = torch.zeros(n, dtype=torch.int32, device=index.device)
    return out.index_add_(0, index.long(), hit.to(torch.int32))


def segment_bounds_ref(keys: torch.Tensor, n: int) -> torch.Tensor:
    """int32[n + 1]: ptr[v] = the first position of the sorted int32
    ``keys`` (values in [0, n]) whose key is >= v, so that the keys equal
    to v are [ptr[v], ptr[v + 1]) and ptr[n] is where keys n begin."""
    v = torch.arange(n + 1, dtype=keys.dtype, device=keys.device)
    return torch.searchsorted(keys, v).to(torch.int32)


def segment_or_ref(ptr: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   flags: torch.Tensor) -> torch.Tensor:
    """bool[V] (V + 1 = ``ptr``'s length): out[v] = the OR of
    ``flags[src[k]]`` over v's segment [ptr[v], ptr[v + 1]) of a sorted
    slot order whose sorted keys are ``dst``; the slots from ptr[V] on are
    dead."""
    V = ptr.shape[0] - 1
    live = torch.arange(src.shape[0], device=src.device) < ptr[V]
    hit = live & flags[torch.where(live, src, 0).long()]
    out = torch.zeros(V + 1, dtype=torch.bool, device=src.device)
    return out.index_fill_(0, torch.where(hit, dst, V).long(), True)[:V]
