"""Straggler mitigation for the frontier workload (twin of
``repro.ft.straggler``).

The DF/DF-P frontier makes work per edge shard skewed: most iterations
touch a small, clustered set of dst windows, so a static edge stripe
leaves most devices idle while one grinds.  Mitigations:

1. **Active-first re-striping** (``rebalance``): re-stripe each dst
   range's edges so edges whose dst was recently affected interleave
   round-robin over the edge axis (``graph/partition.py``
   ``balance_by_active``).
2. **Bounded iterations** (``IterationBudget``): drivers cap each batch
   at ``max_iter`` and carry the still-unconverged frontier into the next
   batch's seed set (correct: DF re-marks until Δ ≤ τ).  The frontier may
   be a NumPy array or a tensor; the serve engine keeps it on its device,
   so carrying it costs no host read.
3. **Skew telemetry** (``stripe_skew``): max/mean active edges per
   stripe; above 2 a driver rebalances.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.graph.partition import PartitionedGraph, host_array, \
    partition_graph
from repro_torch.graph.structure import EdgeListGraph

Mask = Union[np.ndarray, torch.Tensor]


def active_edge_mask(graph: EdgeListGraph, affected: np.ndarray
                     ) -> np.ndarray:
    """bool[E_cap]: live edges whose dst is affected (edges that do work)."""
    dst = host_array(graph.dst)
    valid = host_array(graph.valid)
    return valid & np.asarray(affected)[dst]


def stripe_skew(part: PartitionedGraph, affected: np.ndarray) -> float:
    """max/mean active edges across edge stripes (1.0 = perfectly even)."""
    # v_per_shard is window-rounded, so pad the mask to the padded range
    aff_pad = np.zeros(part.model_shards * part.v_per_shard, bool)
    aff_pad[: len(affected)] = affected
    act = aff_pad[part.dst_local + part.vtx_starts[:, None, None]] \
        & part.valid
    per_stripe = act.sum(axis=2).astype(np.float64)     # [M, P]
    mean = per_stripe.mean()
    if mean == 0:
        return 1.0
    return float(per_stripe.max() / mean)


def rebalance(graph: EdgeListGraph, affected: np.ndarray,
              model_shards: int, edge_shards: int) -> PartitionedGraph:
    """Re-stripe edges with recently active edges spread round-robin."""
    mask = active_edge_mask(graph, affected)
    return partition_graph(graph, model_shards, edge_shards,
                           balance_by_active=mask)


class IterationBudget:
    """Caps per-batch iterations; carries the unconverged frontier on."""

    def __init__(self, max_iter_per_batch: int = 100):
        self.max_iter = max_iter_per_batch
        self.carried_frontier: Optional[Mask] = None

    def seeds_for_batch(self, fresh_seeds: Mask) -> Mask:
        if self.carried_frontier is None:
            return fresh_seeds
        return fresh_seeds | self.carried_frontier

    def after_batch(self, converged: bool, frontier: Optional[Mask]):
        if converged:
            self.carried_frontier = None
        elif isinstance(frontier, torch.Tensor):
            self.carried_frontier = frontier.clone()
        else:
            self.carried_frontier = frontier.copy()
