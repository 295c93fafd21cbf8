"""repro_torch.ppr — incrementally repaired random-walk index for
low-latency personalized PageRank (twin of ``repro.ppr``).

    index = build_walk_index(graph, IndexConfig(num_walks=32))
    verts, est = ppr_top_k(index, seeds=[7], k=10)        # fast path
    index, resampled = repair_walk_index(index, graph_new, touched)

On a mesh, ``build_sharded_walk_index`` splits the steps by start-vertex
range over the ``model`` axis; repair and queries then run a shard at a
time, bit for bit the unsharded walks (``ppr.shard``).
``threefry`` (the walks' PRNG) lives beside the walk-repair kernel, which
makes the same draws, and is re-exported here.
"""
from repro_torch.kernels.walk_repair import threefry
from repro_torch.ppr.estimator import (DEFAULT_MIN_EFFECTIVE_WALKS,
                                       diagnostics, effective_walks,
                                       error_bound, precision_at_k,
                                       truncation_bias, walks_for_error)
from repro_torch.ppr.query import ppr_estimate, ppr_top_k
from repro_torch.ppr.repair import repair_walk_index, stale_walks
from repro_torch.ppr.shard import (ShardedWalkIndex, WalkShardSpec,
                                   build_sharded_walk_index,
                                   repair_walk_index_sharded,
                                   shard_stale_counts, shard_walk_index,
                                   unshard_walk_index)
from repro_torch.ppr.walks import IndexConfig, WalkIndex, build_walk_index

__all__ = [
    "DEFAULT_MIN_EFFECTIVE_WALKS", "IndexConfig", "ShardedWalkIndex",
    "WalkIndex", "WalkShardSpec", "build_sharded_walk_index",
    "build_walk_index", "diagnostics", "effective_walks", "error_bound",
    "ppr_estimate", "ppr_top_k", "precision_at_k", "repair_walk_index",
    "repair_walk_index_sharded", "shard_stale_counts", "shard_walk_index",
    "stale_walks", "threefry", "truncation_bias", "unshard_walk_index",
    "walks_for_error",
]
