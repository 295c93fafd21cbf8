"""Start-vertex-range sharding of the PPR walk index (twin of
``repro.ppr.shard``).

The walk index is O(V·R·L), the largest state of the serving side, while
the rank path is already sharded over the mesh's ``model`` axis
(``dist.pagerank_dist``).  This module splits ``WalkIndex.steps`` by
contiguous start-vertex ranges over the same axis:

  ``steps[s]: int32[vps, R, L]``  shard s owns the walks started at global
                                  vertices [s·vps, (s+1)·vps), on the
                                  mesh's device for shard s; rows past V
                                  (the last shard's padding) are all
                                  ``-1``, which staleness and queries
                                  ignore.

Every draw of a walk is a pure function of (key, **global** walk id, hop)
(``ppr.walks``).  A shard maps its local row (vl, r) to the global id
(s·vps + vl)·R + r and draws from the same stream, so per-shard build and
repair are bit for bit the unsharded ones.  The CSR and the touched mask
stay whole: walks visit any vertex though a shard owns them by start
vertex, and the CSR is O(E) against the steps' O(V·R·L).

One controller drives every shard, as ``dist.pagerank_dist`` does; no
process group is started.  A repair scans each shard's walks against the
touched mask, stacks the shards' stale counts and reads them with one
host read (the unsharded repair's one read, ``ppr.repair``), then
compacts each shard's stale walks in flat order without another read (the
count is known) and re-walks them with one ``walk_repair`` launch a shard
that has any, its ids shifted into the global id space.  An explicit
``capacity`` per shard makes an overflow a ``ShardCapacityError`` naming
the shards; ``check=False`` keeps each shard's first ``capacity`` stale
walks in flat order and leaves the rest stale, as the reference's
sentinel-padded compaction does.  The reference's compiled-program cache
(``TRACE_COUNTS``) has no torch meaning; ``REPAIR_COUNTS`` counts
repairs, resampling shards and dropped walks instead.

Queries never reassemble the index: each shard sums the visit counts of
the sources it owns (``ppr.query``'s fixed-order keyed sum) and the
shards' f64[V] vectors are added in shard order, the reference's one
``psum``.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import note_host_syncs
from repro_torch.graph.structure import CSRView, EdgeListGraph
from repro_torch.kernels.pagerank_spmv.shard import ShardCapacityError
from repro_torch.kernels.walk_repair import threefry
from repro_torch.obs import trace as obs_trace
from repro_torch.ppr.repair import _resample, stale_walks
from repro_torch.ppr.walks import IndexConfig, WalkIndex, _build_steps

__all__ = ["REPAIR_COUNTS", "ShardCapacityError", "ShardedWalkIndex",
           "WalkShardSpec", "build_sharded_walk_index",
           "make_walk_shard_spec", "repair_walk_index_sharded",
           "shard_stale_counts", "shard_walk_index", "sharded_counts",
           "sharded_ppr_estimate", "unshard_walk_index"]

# repairs, shards that resampled, and walks left stale by check=False
REPAIR_COUNTS: collections.Counter = collections.Counter()


class WalkShardSpec(NamedTuple):
    """Static geometry of a sharded walk index."""

    num_shards: int
    vertices_per_shard: int
    num_vertices: int

    @property
    def padded_vertices(self) -> int:
        return self.num_shards * self.vertices_per_shard


def make_walk_shard_spec(num_vertices: int, num_shards: int) -> WalkShardSpec:
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    vps = -(-num_vertices // num_shards)
    return WalkShardSpec(num_shards=num_shards, vertices_per_shard=vps,
                         num_vertices=num_vertices)


@dataclasses.dataclass(frozen=True)
class ShardedWalkIndex:
    """Range-sharded walk index: ``steps[s]`` (int32[vps, R, L]) on shard
    s's device; ``csr`` and ``key`` whole.  ``mesh`` places the shards;
    ``mesh=None`` keeps every shard on the CSR's device (the reference's
    mesh-free path)."""

    steps: Tuple[torch.Tensor, ...]
    csr: CSRView
    key: Tuple[int, int]
    num_walks: int
    max_len: int
    alpha: float
    spec: WalkShardSpec
    mesh: Optional[object] = None

    @property
    def num_vertices(self) -> int:
        return self.spec.num_vertices

    @property
    def num_shards(self) -> int:
        return self.spec.num_shards

    @property
    def device(self) -> torch.device:
        return self.csr.deg.device

    def stacked(self) -> torch.Tensor:
        """int32[S, vps, R, L] on the CSR's device: the reference's one
        sharded leaf (tests and checks; serving never builds it)."""
        return torch.stack([s.to(self.device) for s in self.steps])

    def nbytes(self) -> int:
        return sum(s.numel() for s in self.steps) * 4


def _shard_devices(spec: WalkShardSpec, mesh,
                   default: torch.device) -> List[torch.device]:
    """Shard s's device: the mesh's ``model`` axis entry s when the mesh
    has as many, else ``default`` for every shard."""
    if mesh is not None and mesh.shape.get("model") == spec.num_shards:
        return [torch.device(d) for d in mesh.axis_devices("model")]
    return [default] * spec.num_shards


def _on(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t if t.device == dev else t.to(dev)


def _csr_on(csr: CSRView, dev: torch.device) -> CSRView:
    if csr.deg.device == dev:
        return csr
    return CSRView(*(t.to(dev) for t in csr))


# ---------------------------------------------------------------------------
# shard / unshard / build
# ---------------------------------------------------------------------------

def shard_walk_index(index: WalkIndex, num_shards: int,
                     mesh=None) -> ShardedWalkIndex:
    """Split an unsharded index by start-vertex range.  Padding rows
    (global vertex >= V, on the last shard) are all ``-1``."""
    V, R, L = index.steps.shape
    spec = make_walk_shard_spec(V, num_shards)
    vps = spec.vertices_per_shard
    devs = _shard_devices(spec, mesh, index.device)
    shards = []
    for s, dev in enumerate(devs):
        part = index.steps[s * vps:(s + 1) * vps]
        if part.shape[0] < vps:
            part = torch.cat([part, torch.full(
                (vps - part.shape[0], R, L), -1, dtype=torch.int32,
                device=part.device)])
        else:
            part = part.clone()
        shards.append(_on(part, dev))
    return ShardedWalkIndex(steps=tuple(shards), csr=index.csr,
                            key=index.key, num_walks=index.num_walks,
                            max_len=index.max_len, alpha=index.alpha,
                            spec=spec, mesh=mesh)


def unshard_walk_index(index: ShardedWalkIndex) -> WalkIndex:
    """The unsharded index again (tests and checks only: serving never
    reassembles it)."""
    steps = torch.cat([_on(s, index.device) for s in index.steps]
                      )[:index.spec.num_vertices]
    return WalkIndex(steps=steps, csr=index.csr, key=index.key,
                     num_walks=index.num_walks, max_len=index.max_len,
                     alpha=index.alpha)


def build_sharded_walk_index(graph: EdgeListGraph,
                             config: IndexConfig = IndexConfig(), *,
                             num_shards: Optional[int] = None, mesh=None,
                             chunk_vertices: Optional[int] = None
                             ) -> ShardedWalkIndex:
    """Sample the index in sharded form: each shard builds its own
    start-vertex range with global walk ids on its device, so the result
    equals ``shard_walk_index(build_walk_index(graph, config), S)`` bit
    for bit."""
    if num_shards is None:
        if mesh is None:
            raise ValueError("need num_shards or a mesh")
        num_shards = mesh.shape["model"]
    spec = make_walk_shard_spec(graph.num_vertices, num_shards)
    key = threefry.prng_key(config.seed)
    csr = graph.to_device_csr()
    R, L, alpha = config.num_walks, config.max_len, config.alpha
    vps = spec.vertices_per_shard
    steps = tuple(
        _build_steps(_csr_on(csr, dev), key, spec.num_vertices, R, L, alpha,
                     chunk_vertices, v_start=s * vps, num_local=vps)
        for s, dev in enumerate(_shard_devices(spec, mesh, csr.deg.device)))
    return ShardedWalkIndex(steps=steps, csr=csr, key=key, num_walks=R,
                            max_len=L, alpha=alpha, spec=spec, mesh=mesh)


# ---------------------------------------------------------------------------
# staleness + repair
# ---------------------------------------------------------------------------

def _stale_per_shard(index: ShardedWalkIndex, touched: torch.Tensor):
    """[(stale bool[vps, R], t0 int32[vps, R]) a shard] and the shards'
    stale counts stacked on the index's device, not read."""
    scans = [stale_walks(s, _on(touched, s.device)) for s in index.steps]
    counts = torch.stack([_on(st.sum(dtype=torch.int64), index.device)
                          for st, _ in scans])
    return scans, counts


def _first_stale(stale: torch.Tensor, t0: torch.Tensor, count: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat walk ids int64[count], their first stale hops): the first
    ``count`` stale walks in flat order, with no host read (``count`` is
    known): each stale walk's rank among the stale ones is its slot, and
    every other walk (and any rank past ``count``) lands in one dropped
    slot."""
    sf = stale.reshape(-1)
    n = sf.shape[0]
    rank = torch.cumsum(sf, 0) - 1
    slot = torch.where(sf & (rank < count), rank,
                       torch.full_like(rank, count))
    ids = torch.empty(count + 1, dtype=torch.int64, device=sf.device)
    ids.scatter_(0, slot, torch.arange(n, dtype=torch.int64,
                                       device=sf.device))
    ids = ids[:count]
    return ids, t0.reshape(-1)[ids]


def repair_walk_index_sharded(index: ShardedWalkIndex,
                              graph_new: EdgeListGraph,
                              touched: torch.Tensor, *,
                              min_capacity: int = 64,
                              capacity: Optional[int] = None,
                              check: bool = True
                              ) -> Tuple[ShardedWalkIndex, int]:
    """Sharded twin of ``repair_walk_index``: each shard repairs its own
    stale walks; the result is bit for bit unsharding, repairing and
    resharding.  Returns (index, walks found stale).

    ``capacity`` is an explicit per-shard budget: a shard with more stale
    walks raises ``ShardCapacityError`` naming the shards, or with
    ``check=False`` re-walks its first ``capacity`` stale walks in flat
    order and leaves the rest stale.  Without it the budget is a shard's
    walk count, which cannot overflow.  ``min_capacity`` sizes the
    reference's compiled buckets and changes no walk here.  One host read
    (the shards' stacked stale counts); one ``walk_repair`` launch a
    shard that has stale walks."""
    del min_capacity
    tr = obs_trace.get_tracer()
    s0 = tr.now()
    spec = index.spec
    R = index.num_walks
    csr_new = graph_new.to_device_csr()
    scans, counts = _stale_per_shard(index, touched)
    note_host_syncs()
    counts_h = counts.tolist()                # the repair's one host read
    num_stale = int(sum(counts_h))
    REPAIR_COUNTS["repairs"] += 1
    if num_stale == 0:
        tr.record("ppr.repair_sharded", s0, tr.now() - s0, stale=0,
                  shards=spec.num_shards)
        return dataclasses.replace(index, csr=csr_new), 0
    nl = spec.vertices_per_shard * R
    budget = nl if capacity is None else min(capacity, nl)
    over = [s for s, c in enumerate(counts_h) if c > budget]
    if over:
        if check:
            raise ShardCapacityError(
                f"stale-walk compaction overflow: {max(counts_h)} stale "
                f"walks on one shard exceed the budget {budget} on shards "
                f"{over} (raise capacity or repair unsharded)", shards=over)
        REPAIR_COUNTS["dropped_stale"] += sum(counts_h[s] - budget
                                              for s in over)
    steps = list(index.steps)
    for s, ((stale, t0), c) in enumerate(zip(scans, counts_h)):
        if c == 0:
            continue
        ids, t0_sel = _first_stale(stale, t0, min(c, budget))
        steps[s] = _resample(_csr_on(csr_new, steps[s].device), index.key,
                             steps[s], ids, t0_sel, index.alpha,
                             id_offset=s * nl)
        REPAIR_COUNTS["shard_resamples"] += 1
    tr.sync(steps[-1])
    tr.record("ppr.repair_sharded", s0, tr.now() - s0, stale=num_stale,
              shards=spec.num_shards)
    return dataclasses.replace(index, steps=tuple(steps),
                               csr=csr_new), num_stale


def shard_stale_counts(index: ShardedWalkIndex,
                       touched: torch.Tensor) -> np.ndarray:
    """int64[S] stale-walk counts a shard (the load-balance signal)."""
    _, counts = _stale_per_shard(index, touched)
    note_host_syncs()
    return counts.cpu().numpy()


# ---------------------------------------------------------------------------
# queries: a keyed sum a shard, added in shard order
# ---------------------------------------------------------------------------

def sharded_counts(index: ShardedWalkIndex, sources: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """f64[V] visit counts over the sharded rows: each shard sums the
    sources it owns (``query._counts_local``), then the shards' vectors
    are added in shard order on the index's device."""
    from repro_torch.ppr.query import _counts_local
    vps, V = index.spec.vertices_per_shard, index.spec.num_vertices
    est = None
    for s, steps in enumerate(index.steps):
        dev = steps.device
        c = _on(_counts_local(steps, _on(sources, dev), _on(weights, dev),
                              s * vps, V), index.device)
        est = c if est is None else est + c
    return est


def sharded_ppr_estimate(index: ShardedWalkIndex, seeds: Sequence[int],
                         normalize: bool = True,
                         unroll: bool = True) -> torch.Tensor:
    """Sharded twin of ``query.ppr_estimate``: the same estimator, its
    visit counts summed a shard at a time (equal to the unsharded
    estimate to f64 rounding: the shards add in another order)."""
    from repro_torch.ppr.query import ppr_estimate
    return ppr_estimate(index, seeds, normalize=normalize, unroll=unroll)
