"""repro_torch.ppr — incrementally repaired random-walk index for
low-latency personalized PageRank (twin of ``repro.ppr``, single device).

    index = build_walk_index(graph, IndexConfig(num_walks=32))
    verts, est = ppr_top_k(index, seeds=[7], k=10)        # fast path
    index, resampled = repair_walk_index(index, graph_new, touched)

The reference's range-sharded index (``repro.ppr.shard``) is not ported.
"""
from repro_torch.ppr.estimator import (DEFAULT_MIN_EFFECTIVE_WALKS,
                                       diagnostics, effective_walks,
                                       error_bound, precision_at_k,
                                       truncation_bias, walks_for_error)
from repro_torch.ppr.query import ppr_estimate, ppr_top_k
from repro_torch.ppr.repair import repair_walk_index, stale_walks
from repro_torch.ppr.walks import IndexConfig, WalkIndex, build_walk_index

__all__ = [
    "DEFAULT_MIN_EFFECTIVE_WALKS", "IndexConfig", "WalkIndex",
    "build_walk_index", "diagnostics", "effective_walks", "error_bound",
    "ppr_estimate", "ppr_top_k", "precision_at_k", "repair_walk_index",
    "stale_walks", "truncation_bias", "walks_for_error",
]
