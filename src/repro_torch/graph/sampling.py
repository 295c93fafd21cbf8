"""GraphSAGE-style neighbour sampling (required for ``minibatch_lg``; twin
of ``repro.graph.sampling``, host NumPy code as it is there: one seed
gives the reference's blocks bit for bit).

Host-side sampler over a NumPy CSR view (the device graph is edge-list; we
keep a CSR mirror for sampling).  Produces *fanout-padded* block arrays with
static shapes:

layer l block:  nodes  int32[B_l]        (B_l = batch * prod(fanouts[:l]))
                parent int32[B_l]        (index into layer l-1 block)
                mask   bool[B_l]

The GNN consumes blocks innermost-first (GraphSAGE §3.1 minibatch algo).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass
class SampledBlock:
    nodes: np.ndarray    # int32[B] global vertex ids (0 where masked)
    parent: np.ndarray   # int32[B] index into previous layer's nodes
    mask: np.ndarray     # bool[B]


@dataclass
class SampledBatch:
    seeds: np.ndarray               # int32[batch]
    blocks: List[SampledBlock]      # one per hop, outermost hop last
    all_nodes: np.ndarray           # unique node ids (padded)
    all_mask: np.ndarray


class NeighborSampler:
    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 fanouts: Sequence[int], seed: int = 0):
        self.indptr = indptr
        self.indices = indices
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray) -> SampledBatch:
        seeds = np.asarray(seeds, np.int32)
        frontier_nodes = seeds
        frontier_mask = np.ones(len(seeds), bool)
        blocks: List[SampledBlock] = []
        for fanout in self.fanouts:
            B = len(frontier_nodes) * fanout
            nodes = np.zeros(B, np.int32)
            parent = np.repeat(np.arange(len(frontier_nodes), dtype=np.int32),
                               fanout)
            mask = np.zeros(B, bool)
            for i, (v, ok) in enumerate(zip(frontier_nodes, frontier_mask)):
                if not ok:
                    continue
                lo, hi = self.indptr[v], self.indptr[v + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = min(fanout, deg)
                picks = self.rng.choice(deg, size=take, replace=False)
                sel = self.indices[lo + picks]
                nodes[i * fanout: i * fanout + take] = sel
                mask[i * fanout: i * fanout + take] = True
            blocks.append(SampledBlock(nodes, parent, mask))
            frontier_nodes, frontier_mask = nodes, mask
        uniq = np.unique(np.concatenate(
            [seeds] + [b.nodes[b.mask] for b in blocks]))
        cap = len(seeds) * int(np.prod([f + 1 for f in self.fanouts]))
        all_nodes = np.zeros(cap, np.int32)
        all_mask = np.zeros(cap, bool)
        take = min(cap, len(uniq))
        all_nodes[:take] = uniq[:take]
        all_mask[:take] = True
        return SampledBatch(seeds, blocks, all_nodes, all_mask)
