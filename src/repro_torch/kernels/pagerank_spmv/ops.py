"""Public wrapper for the frontier-gated SpMV (twin of
``repro.kernels.pagerank_spmv.ops``).

By default dispatch is by device: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel (``frontier_spmv_padded``).
``use_kernel=True`` insists on the kernel (and raises on the CPU),
``False`` on the plain version (and raises on a CUDA tensor).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.pagerank_spmv.pagerank_spmv import (
    DEFAULT_BE, DEFAULT_VB, PackedGraph, frontier_spmv_padded, pack_blocks)

__all__ = ["PackedGraph", "pack_blocks", "gated_contrib", "DEFAULT_BE",
           "DEFAULT_VB"]


def gated_contrib(packed: PackedGraph, ranks: torch.Tensor,
                  inv_deg: torch.Tensor,
                  affected: Optional[torch.Tensor] = None, *,
                  active_window: Optional[torch.Tensor] = None,
                  pad_out: bool = False, use_kernel="auto") -> torch.Tensor:
    """contrib[v] = Σ_{u→v, u≠v} R[u]/d_u for v in active windows, else 0.

    Gating is either ``affected`` (bool[V], reduced to windows here) or a
    precomputed ``active_window`` (bool[NW]).  An iteration loop passes
    ``active_window`` plus pre-padded ``ranks``/``inv_deg`` (length
    NW*VB) and ``pad_out=True``.  ``use_kernel``: as
    ``frontier_spmv_padded`` takes it ("auto" dispatches by device).
    """
    if active_window is None:
        if affected is None:
            raise ValueError("need affected or active_window")
        active_window = packed.active_windows(affected)
    # frontier_spmv_padded zero-pads a short rsc itself
    rsc = (ranks * inv_deg).to(torch.float32)
    out = frontier_spmv_padded(packed, rsc, active_window,
                               use_kernel=use_kernel)
    return out if pad_out else out[: packed.num_vertices]
