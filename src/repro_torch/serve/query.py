"""Query surface over the front snapshot: point ranks, top-k and
personalized top-k (twin of ``repro.serve.query``).

Every query reads ONE atomically published ``Snapshot`` and carries the
generation it was served from.  Staleness is measured in events: how many
accepted ingest events the snapshot's ``last_seq`` trails the newest
submitted seq at query time.

``personalized_top_k`` has two paths, selected by ``mode``:

* ``"index"``: answer from the snapshot's random-walk index
  (``repro_torch.ppr``), a few device ops per query; requires the engine
  to keep one (``ServeEngine(ppr_index=...)``).
* ``"exact"``: a full PPR solve on the snapshot graph
  (``core.extensions.personalized_pagerank``), the accuracy oracle.
  Solves are memoized per (generation, seed set, solver options), so a
  repeated query within a generation solves once.
* ``"auto"`` (default): the index when the snapshot carries one, no
  solver options were passed (they imply exact semantics), AND the seed
  set's effective sample (Σ deg·R, ``ppr.effective_walks``) reaches
  ``ppr.DEFAULT_MIN_EFFECTIVE_WALKS``; the exact path otherwise.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.extensions import personalized_pagerank
from repro_torch.ppr import DEFAULT_MIN_EFFECTIVE_WALKS, effective_walks, \
    ppr_top_k
from repro_torch.serve.ingest import IngestQueue
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.state import RankStore

_EXACT_CACHE_MAX = 32


class QueryResult(NamedTuple):
    vertices: np.ndarray   # int64[k]
    ranks: np.ndarray      # f64[k]
    generation: int
    staleness_events: int


def _topk(ranks: torch.Tensor, k: int):
    vals, idx = torch.topk(ranks, k)
    return idx.cpu().numpy().astype(np.int64), vals.cpu().numpy()


class QueryClient:
    def __init__(self, store: RankStore, ingest: Optional[IngestQueue] = None,
                 metrics: Optional[ServeMetrics] = None):
        self.store = store
        self.ingest = ingest
        self.metrics = metrics
        # exact-PPR memo: (generation, seeds, solver kw) -> rank vector;
        # queries run from any thread, so cache ops take the lock
        self._exact_cache: OrderedDict = OrderedDict()
        self._cache_lock = threading.Lock()

    def _staleness(self, snap) -> int:
        if self.ingest is None:
            return 0
        return max(0, self.ingest.latest_seq - snap.last_seq)

    def _record(self, staleness: int):
        if self.metrics is not None:
            self.metrics.record_query(staleness)

    def get_ranks(self, vertices: Sequence[int]) -> QueryResult:
        """Point lookups of the current ranks for the given vertices."""
        snap = self.store.snapshot()
        verts = np.asarray(vertices, np.int64).reshape(-1)
        idx = torch.from_numpy(verts).to(snap.ranks.device)
        stale = self._staleness(snap)
        self._record(stale)
        return QueryResult(verts, snap.ranks[idx].cpu().numpy(),
                           snap.generation, stale)

    def top_k(self, k: int) -> QueryResult:
        """The k highest-ranked vertices, highest first."""
        snap = self.store.snapshot()
        idx, vals = _topk(snap.ranks, k)
        stale = self._staleness(snap)
        self._record(stale)
        return QueryResult(idx, vals, snap.generation, stale)

    def _exact_ppr_ranks(self, snap, seeds: np.ndarray,
                         **ppr_kw) -> torch.Tensor:
        """Memoized exact PPR solve on one snapshot (LRU per (generation,
        seed set, options)): a published snapshot is immutable, so the
        solution cannot change within a generation."""
        key = (snap.generation, tuple(sorted(set(int(s) for s in seeds))),
               tuple(sorted(ppr_kw.items())))
        with self._cache_lock:
            ranks = self._exact_cache.get(key)
            if ranks is not None:
                self._exact_cache.move_to_end(key)
                return ranks
        # solve outside the lock; a concurrent identical query may repeat
        # the solve, which is wasteful but correct
        graph = snap.graph
        seed_mask = torch.zeros(graph.num_vertices, dtype=torch.bool,
                                device=graph.device)
        seed_mask[torch.from_numpy(seeds).to(graph.device)] = True
        ranks = personalized_pagerank(graph, seed_mask, **ppr_kw).ranks
        with self._cache_lock:
            while len(self._exact_cache) >= _EXACT_CACHE_MAX:
                self._exact_cache.popitem(last=False)
            self._exact_cache[key] = ranks
        return ranks

    def personalized_top_k(self, seeds: Sequence[int], k: int,
                           mode: str = "auto", **ppr_kw) -> QueryResult:
        """Top-k by personalized PageRank from a seed set, on the snapshot
        (see the module docstring for the index/exact/auto routing)."""
        if mode not in ("auto", "index", "exact"):
            raise ValueError(f"unknown personalized_top_k mode {mode!r}")
        snap = self.store.snapshot()
        seeds = np.asarray(seeds, np.int64).reshape(-1)
        if len(seeds) == 0 or seeds.min() < 0 or \
                seeds.max() >= snap.graph.num_vertices:
            raise ValueError("seeds must be non-empty and within "
                             f"[0, {snap.graph.num_vertices})")
        index = snap.ppr_index
        if mode == "index" and index is None:
            raise ValueError("mode='index' but the snapshot carries no walk "
                             "index (start ServeEngine with ppr_index=)")
        if mode == "index" and ppr_kw:
            raise ValueError("solver options are exact-path only; "
                             f"mode='index' got {sorted(ppr_kw)}")
        # auto: solver options imply the exact solver's semantics, so
        # their presence routes to it (only explicit mode="index" rejects)
        use_index = index is not None and (
            mode == "index" or
            (mode == "auto" and not ppr_kw and
             effective_walks(index, seeds) >= DEFAULT_MIN_EFFECTIVE_WALKS))
        if use_index:
            idx, vals = ppr_top_k(index, seeds, k)
            idx, vals = idx.cpu().numpy().astype(np.int64), vals.cpu().numpy()
        else:
            idx, vals = _topk(self._exact_ppr_ranks(snap, seeds, **ppr_kw),
                              k)
        stale = self._staleness(snap)
        self._record(stale)
        return QueryResult(idx, vals, snap.generation, stale)
