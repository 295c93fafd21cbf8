"""2-D graph partition for a multi-device layout (twin of
``repro.graph.partition``; host NumPy, arrays equal to the reference's).

The ``model`` axis owns contiguous **dst ranges** (vertex state lives
there); the ``data`` axes stripe the edges *within* each dst range.  The
partition is a pure function of (V, E_cap, layout shape), so elastic
rescaling (``ft/elastic.py``) is a repartition of host arrays, nothing
more.  Each dst range's slice is padded to one per-device edge capacity.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import note_host_syncs
from repro_torch.graph.structure import EdgeListGraph


@dataclass
class PartitionedGraph:
    """Host-side partitioned arrays, layout [model, edge_par, E_dev]."""

    src: np.ndarray        # int32[M, P, E_dev]
    dst_local: np.ndarray  # int32[M, P, E_dev]  (dst - range_start)
    valid: np.ndarray      # bool[M, P, E_dev]
    vtx_starts: np.ndarray  # int32[M] dst-range starts
    num_vertices: int
    v_per_shard: int

    @property
    def model_shards(self) -> int:
        return self.src.shape[0]

    @property
    def edge_shards(self) -> int:
        return self.src.shape[1]


def host_array(x) -> np.ndarray:
    """A NumPy copy of a tensor (a recorded host sync) or an array."""
    if isinstance(x, torch.Tensor):
        note_host_syncs()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def vertices_per_shard(num_vertices: int, model_shards: int,
                       window: int = 512) -> int:
    """dst-range length per ``model`` shard, rounded up to ``window``."""
    v_per = -(-num_vertices // model_shards)          # ceil
    return -(-v_per // window) * window


def edges_per_device(edge_capacity: int, model_shards: int,
                     edge_shards: int, lane: int = 128) -> int:
    """Balanced per-device edge slots, rounded up to ``lane``: the dry-run's
    input shapes (``dist.pagerank_dist.distributed_input_specs``).  A
    skewed graph's ``partition_graph`` grows past this floor."""
    e_dev = -(-edge_capacity // max(1, model_shards * edge_shards))
    return max(lane, -(-e_dev // lane) * lane)


def partition_graph(graph: EdgeListGraph, model_shards: int,
                    edge_shards: int, balance_by_active: np.ndarray = None,
                    window: int = 512,
                    min_edges_per_device: int = 0) -> PartitionedGraph:
    """dst-range × edge-stripe partition.

    ``balance_by_active``: optional bool[E_cap]; live edges whose flag is
    set are striped first, so active work spreads evenly over the edge
    axis.  ``window``: ``v_per_shard`` is rounded up to a multiple of it.
    ``min_edges_per_device``: a floor for the per-device edge capacity.
    """
    V = graph.num_vertices
    v_per = vertices_per_shard(V, model_shards, window)
    src = host_array(graph.src)
    dst = host_array(graph.dst)
    valid = host_array(graph.valid)

    per_range_edges = []
    for m in range(model_shards):
        lo, hi = m * v_per, min((m + 1) * v_per, V)
        sel = valid & (dst >= lo) & (dst < hi)
        idx = np.nonzero(sel)[0]
        if balance_by_active is not None and len(idx):
            act = balance_by_active[idx]
            idx = np.concatenate([idx[act], idx[~act]])
        per_range_edges.append(idx)

    e_dev = max(8, max((len(i) for i in per_range_edges), default=8))
    e_dev = -(-e_dev // edge_shards)
    e_dev = -(-e_dev // 128) * 128                    # a lane multiple
    e_dev = max(e_dev, min_edges_per_device)

    S = np.zeros((model_shards, edge_shards, e_dev), np.int32)
    D = np.zeros((model_shards, edge_shards, e_dev), np.int32)
    M = np.zeros((model_shards, edge_shards, e_dev), bool)
    for m, idx in enumerate(per_range_edges):
        lo = m * v_per
        # round-robin stripe over the edge axis (interleaves active-first)
        for p in range(edge_shards):
            part = idx[p::edge_shards][:e_dev]
            S[m, p, : len(part)] = src[part]
            D[m, p, : len(part)] = dst[part] - lo
            M[m, p, : len(part)] = True
    starts = np.arange(model_shards, dtype=np.int32) * v_per
    return PartitionedGraph(S, D, M, starts, V, v_per)
