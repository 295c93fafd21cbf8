"""Plain PyTorch version of the edge-slot count (``csrc/slot_count.cu``):
the int32 ``index_add_`` that ``graph.structure._count`` was.  The counts
are integers, so the kernel's atomics give the same result in any order.
"""
from __future__ import annotations

from typing import Optional

import torch


def slot_count_ref(index: torch.Tensor, weight: torch.Tensor, n: int,
                   gather: Optional[torch.Tensor] = None,
                   flags: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32[n]: the number of slots e with ``weight[e]`` set (and
    ``flags[gather[e]]`` set, when ``gather`` is given) whose
    ``index[e]`` is each value."""
    hit = weight if gather is None else weight & flags[gather.long()]
    out = torch.zeros(n, dtype=torch.int32, device=index.device)
    return out.index_add_(0, index.long(), hit.to(torch.int32))
