"""Public wrapper for the gated segment-SpMM (twin of
``repro.kernels.segment_ops.ops``).

Dispatch is by device, not by a switch: a CPU ``feats`` runs the plain
version, a CUDA ``feats`` launches the kernel (``gated_spmm``).  The plain
version alone is ``ref.gated_spmm_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.pagerank_spmv.pagerank_spmv import PackedGraph
from repro_torch.kernels.segment_ops.segment_matmul import gated_spmm

__all__ = ["aggregate_features"]


def aggregate_features(packed: PackedGraph, feats: torch.Tensor,
                       affected: torch.Tensor) -> torch.Tensor:
    """Σ_{u→v} feats[u] for v in windows containing any affected vertex,
    else 0: f32[num_vertices, D].  ``affected``: bool[num_vertices]."""
    return gated_spmm(packed, feats, packed.active_windows(affected))
