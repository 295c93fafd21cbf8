"""Query surface over the front snapshot: point ranks and top-k (twin of
``repro.serve.query``; personalized top-k is not ported yet).

Every query reads ONE atomically published ``Snapshot`` and carries the
generation it was served from.  Staleness is measured in events: how many
accepted ingest events the snapshot's ``last_seq`` trails the newest
submitted seq at query time.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.serve.ingest import IngestQueue
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.state import RankStore


class QueryResult(NamedTuple):
    vertices: np.ndarray   # int64[k]
    ranks: np.ndarray      # f64[k]
    generation: int
    staleness_events: int


class QueryClient:
    def __init__(self, store: RankStore, ingest: Optional[IngestQueue] = None,
                 metrics: Optional[ServeMetrics] = None):
        self.store = store
        self.ingest = ingest
        self.metrics = metrics

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
        vals, idx = torch.topk(snap.ranks, k)
        stale = self._staleness(snap)
        self._record(stale)
        return QueryResult(idx.cpu().numpy().astype(np.int64),
                           vals.cpu().numpy(), snap.generation, stale)
