"""The DF frontier driving incremental GNN embedding refresh (twin of
``repro.core.incremental_gnn``; DESIGN.md §5).

The paper's rule (changes propagate along out-edges; re-process a vertex
only while its value still moves more than a tolerance) applied to GNN
inference on a dynamic graph:

  * a batch update touches endpoints, and their out-neighbours'
    embeddings are stale (the initial frontier, Alg. 1 lines 4-6);
  * affected vertices take the new embeddings; a vertex whose embedding
    moves more than τ_f in relative L2 norm adds its out-neighbours to
    the frontier;
  * a GNN has a finite receptive field, so the loop runs ``n_layers``
    rounds, marking then recomputing.

The rounds are a Python loop of ``push_or`` with no host read inside it;
``nodes_recomputed`` stays on the device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.graph.structure import EdgeListGraph


class RefreshResult(NamedTuple):
    embeddings: torch.Tensor        # f32[N, D]
    affected_ever: torch.Tensor     # bool[N]
    rounds: int
    nodes_recomputed: torch.Tensor  # int64[] on the device


def incremental_refresh(graph: EdgeListGraph, feats: torch.Tensor,
                        old_embeddings: torch.Tensor, touched: torch.Tensor,
                        layer_fn: Callable, n_layers: int,
                        frontier_tol: float = 1e-3) -> RefreshResult:
    """Refresh node embeddings after a batch update.

    ``layer_fn(graph, feats)`` is the full-graph one-shot GNN forward; it
    runs once and the result is blended per the frontier: affected
    vertices take the new values, the rest keep the old.  Expansion runs
    ``n_layers`` rounds (the receptive field).  Returns embeddings equal
    to the full recompute on the affected receptive field and old values
    elsewhere; ``affected_ever`` reports the work skipped.
    """
    affected = touched | graph.push_or(touched)
    with torch.no_grad():        # serving: no parameter gradient is kept
        new_full = layer_fn(graph, feats)
    # relative movement of each candidate vertex (Δr/r on vectors)
    dn = torch.linalg.vector_norm(new_full - old_embeddings, dim=-1)
    base = torch.linalg.vector_norm(old_embeddings, dim=-1).clamp(min=1e-12)
    rel = dn / base
    for _ in range(n_layers):
        moved = affected & (rel > frontier_tol)    # expansion test (τ_f)
        affected = affected | graph.push_or(moved)
    emb = torch.where(affected[:, None], new_full, old_embeddings)
    # the reference tracks `ever` beside `affected`; both start equal and
    # take the same expansion each round, so they are one set
    return RefreshResult(emb, affected, n_layers,
                         affected.sum(dtype=torch.int64))
