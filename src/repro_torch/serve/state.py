"""Double-buffered rank snapshots (twin of ``repro.serve.state``).

The engine mutates a *back* state (graph, ranks) batch after batch;
``publish`` atomically swaps a new immutable ``Snapshot`` in as the
*front* buffer.  Queries read the front pointer under a lock held only for
the pointer copy, so a query never observes a torn (graph, ranks) pair.

``generation`` increments on every publish and is the serving system's
logical clock; ``last_seq`` records the newest ingest event folded into
the snapshot.  A PPR walk index, when the engine keeps one, rides in the
same snapshot, so index queries see the graph the ranks were solved on.
Checkpointed restart (``ckpt_dir``) is not ported yet.
"""
from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import torch

from repro_torch.graph.structure import EdgeListGraph


class Snapshot(NamedTuple):
    graph: EdgeListGraph
    ranks: torch.Tensor  # f64[V]
    generation: int      # publish counter, monotone from 0
    last_seq: int        # newest ingest seq reflected in `ranks`
    # walk index maintained for THIS graph (repro_torch.ppr), or None when
    # the engine runs without one
    ppr_index: Optional[object] = None


class RankStore:
    """Front-buffer snapshot holder."""

    def __init__(self, ckpt_dir: Optional[str] = None):
        if ckpt_dir is not None:
            raise NotImplementedError(
                "RankStore(ckpt_dir=...): checkpointed restart is not "
                "ported yet")
        self._lock = threading.Lock()
        self._snap: Optional[Snapshot] = None
        self._next_gen = 0

    def seed_generation(self, generation: int):
        """Continue the generation clock from ``generation``."""
        with self._lock:
            self._next_gen = generation

    def publish(self, graph: EdgeListGraph, ranks: torch.Tensor,
                last_seq: int, ppr_index=None) -> int:
        """Swap in a new front snapshot; returns its generation."""
        with self._lock:
            gen = self._next_gen
            self._next_gen += 1
            self._snap = Snapshot(graph, ranks, gen, int(last_seq),
                                  ppr_index)
        return gen

    def snapshot(self) -> Snapshot:
        """The current front buffer (raises before the first publish)."""
        with self._lock:
            if self._snap is None:
                raise RuntimeError("RankStore has no published snapshot yet "
                                   "(call ServeEngine.bootstrap first)")
            return self._snap

    @property
    def generation(self) -> int:
        with self._lock:
            return -1 if self._snap is None else self._snap.generation
