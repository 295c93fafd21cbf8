"""PPR queries over a WalkIndex: visit-count aggregation and top-k (twin of
``repro.ppr.query``).

The expected number of visits to v by one decay-terminated walk from s is
PPR(s, v)/(1-α), so scaled visit counts over the R stored walks estimate
the PPR vector.  Queries apply **one-step unrolling** through the
implicit-self-loop closed form:

    π_s = [ (1-α)·e_s + α/(d_s+1) · Σ_{u ∈ N⁺(s)} π_u ] / (1 − α/(d_s+1))

so a seed's estimate mixes its out-neighbours' walk sets (d·R walks
instead of R) plus a point mass at the seed.  Seed sets average the
per-seed estimates (uniform teleport over the seeds, the contract of
``core.extensions.personalized_pagerank``).  ``unroll=False`` gives the
raw R-walk estimator.

Everything is f64.  Visit counts are summed in a fixed order: the walk
positions are sorted stably by the vertex they visit, and each vertex's
terms are summed over them in ``kernels.pull_contrib``'s chunked order
(chunks of at most ``PULL_CHUNK`` positions, each added in position order
from +0.0, then the chunks in order), so an estimate is the same bit for
bit from run to run and on the card and the CPU.  That is another order than the reference's
``segment_sum``: estimates agree with the reference to rounding, not bit
for bit.  Nothing is
compiled, so seed and neighbour blocks are not padded to power-of-two
buckets; the neighbour axis still goes in slabs of at most
``_MAX_NBR_WIDTH`` columns to bound the gather a hub seed costs.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.pull_contrib.pull_contrib import PullOrder, \
    pull_values, sorted_slots
from repro_torch.ppr.walks import WalkIndex

F64 = torch.float64
_MAX_NBR_WIDTH = 1024   # neighbour-slab width cap (bounds the gather)


def _keyed_sum(keys: torch.Tensor, rows: int, values: torch.Tensor,
               V: int) -> torch.Tensor:
    """f64[V]: out[v] = Σ values[i // rows] over the positions i with
    ``keys[i] == v`` (a negative key is no vertex), in a fixed order: one
    stable sort of the positions by key, then the chunked pull sum of
    ``values`` (every source i // rows lies in
    [0, len(values)) when ``keys`` has ``rows`` positions a value)."""
    ptr, perm, _ = sorted_slots(keys, keys >= 0, V)
    order = PullOrder(ptr, torch.div(perm, rows, rounding_mode="floor")
                      .to(torch.int32))
    return pull_values(order, values)


def _counts_local(steps: torch.Tensor, sources: torch.Tensor,
                  weights: torch.Tensor, v_start: int,
                  num_vertices: int) -> torch.Tensor:
    """f64[num_vertices] visit counts contributed by the rows of one
    start-vertex range [v_start, v_start + steps.shape[0]): sources
    outside the range add nothing, so adding the ranges' results gives the
    whole aggregation (``ppr.shard``).  With ``v_start=0`` and a whole
    index this is the unsharded aggregation."""
    vps, R, L = steps.shape
    loc = sources.long() - v_start
    own = (loc >= 0) & (loc < vps)
    sel = steps[loc.clamp(0, vps - 1)]                    # [B, R, L]
    keys = torch.where(own[:, None, None], sel, -1)
    return _keyed_sum(keys.reshape(-1), R * L, weights, num_vertices)


def _counts(steps: torch.Tensor, sources: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    """f64[V] Σ over walk positions of the gathered ``sources`` rows,
    each position weighted by its source's scalar weight."""
    return _counts_local(steps, sources, weights, 0, steps.shape[0])


def _index_counts(index):
    """(sources, weights) -> f64[V] visit counts over ``index``'s walks,
    whole or sharded."""
    if isinstance(index, WalkIndex):
        return lambda s, w: _counts(index.steps, s, w)
    from repro_torch.ppr.shard import sharded_counts
    return lambda s, w: sharded_counts(index, s, w)


def _direct_estimate(index, seeds: torch.Tensor,
                     normalize: bool) -> torch.Tensor:
    """Raw estimator: (1-α)/R · visit counts of the seeds' own walks."""
    R, alpha = index.num_walks, index.alpha
    n_seeds = float(seeds.shape[0])
    w = torch.full(seeds.shape, (1.0 - alpha) / (R * n_seeds), dtype=F64,
                   device=seeds.device)
    est = _index_counts(index)(seeds, w)
    if normalize:
        est = est / est.sum().clamp(min=1e-300)
    return est


def _nbr_slab(indptr: torch.Tensor, indices: torch.Tensor, deg: torch.Tensor,
              alpha: float, seeds: torch.Tensor, offset: int, width: int,
              num_walks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sources int32[S·width], weights f64[S·width]): neighbour columns
    [offset, offset+width) of each seed's CSR row with their per-walk-
    position weights (``deg`` is f64)."""
    E = indices.shape[0]
    R = num_walks
    n_seeds = float(seeds.shape[0])
    d = deg[seeds.long()]                                 # [S]
    z = 1.0 - alpha / (d + 1.0)                           # closed-form denom
    col = offset + torch.arange(width, dtype=torch.int32,
                                device=seeds.device)[None, :]
    nbr_ok = col < d[:, None]
    pos = (indptr[seeds.long()][:, None] + col).clamp(0, E - 1)
    nbr = torch.where(nbr_ok, indices[pos.long()], 0)
    # per-source weight of one walk position:  α(1-α) / ((d+1)·z·R·|S|)
    w_nbr = torch.where(
        nbr_ok, alpha * (1.0 - alpha)
        / ((d[:, None] + 1.0) * z[:, None] * R * n_seeds),
        torch.zeros((), dtype=F64, device=seeds.device))
    return nbr.reshape(-1), w_nbr.reshape(-1)


def _seed_point_mass(est: torch.Tensor, deg: torch.Tensor, alpha: float,
                     seeds: torch.Tensor) -> torch.Tensor:
    """Add each seed's closed-form point mass (1-α)/(z·|S|); the masses of
    a repeated seed are summed in seed order first."""
    n_seeds = float(seeds.shape[0])
    z = 1.0 - alpha / (deg[seeds.long()] + 1.0)
    mass = _keyed_sum(seeds, 1, (1.0 - alpha) / (z * n_seeds),
                      est.shape[0])
    return est + mass


def _unrolled_estimate(index, seeds: torch.Tensor, nbr_cap: int,
                       normalize: bool) -> torch.Tensor:
    """One-step-unrolled estimate, the neighbour axis in slabs of at most
    ``_MAX_NBR_WIDTH`` columns (each a bounded slab of visit counts)."""
    deg = index.csr.deg.to(F64)
    counts = _index_counts(index)
    width = min(nbr_cap, _MAX_NBR_WIDTH)
    est = None
    for offset in range(0, nbr_cap, width):
        nbr, w_nbr = _nbr_slab(index.csr.indptr, index.csr.indices, deg,
                               index.alpha, seeds, offset, width,
                               index.num_walks)
        c = counts(nbr, w_nbr)
        est = c if est is None else est + c
    est = _seed_point_mass(est, deg, index.alpha, seeds)
    if normalize:
        est = est / est.sum().clamp(min=1e-300)
    return est


def _seed_index(seeds: Sequence[int], V: int,
                device: torch.device) -> torch.Tensor:
    """int32[S] sorted unique seeds, checked against [0, V) (the
    reference's ``_pad_seeds`` without its power-of-two padding, which
    only serves its compile cache)."""
    s = np.unique(np.asarray(seeds, np.int64).reshape(-1))
    if len(s) == 0:
        raise ValueError("PPR query needs at least one seed")
    if s.min() < 0 or s.max() >= V:
        raise ValueError(f"seed out of range [0, {V})")
    return torch.from_numpy(s.astype(np.int32)).to(device)


def _nbr_cap(index, seeds: torch.Tensor) -> int:
    """Neighbour-block width covering the query's largest seed (≥ 1); one
    host read."""
    return max(1, int(index.csr.deg[seeds.long()].max()))


def ppr_estimate(index, seeds: Sequence[int], normalize: bool = True,
                 unroll: bool = True) -> torch.Tensor:
    """f64[V] estimated PPR vector for a seed set (uniform teleport over
    the seeds).  ``normalize=True`` rescales to a distribution (absorbs
    the α^L truncation tail); top-k is unaffected either way.

    Accepts a ``ShardedWalkIndex`` too: the visit counts are then summed
    a shard at a time over that shard's rows and the shards' vectors
    added in shard order; the walks never leave their shards
    (``ppr.shard``)."""
    s = _seed_index(seeds, index.num_vertices, index.device)
    if not unroll:
        return _direct_estimate(index, s, normalize)
    return _unrolled_estimate(index, s, _nbr_cap(index, s), normalize)


def ppr_top_k(index, seeds: Sequence[int], k: int,
              unroll: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vertices int64[k], estimates f64[k]), highest first: the serving
    fast path."""
    vals, idx = torch.topk(ppr_estimate(index, seeds, unroll=unroll), k)
    return idx, vals
