"""Double-buffered rank snapshots (twin of ``repro.serve.state``).

The engine mutates a *back* state (graph, ranks) batch after batch;
``publish`` atomically swaps a new immutable ``Snapshot`` in as the
*front* buffer.  Queries read the front pointer under a lock held only for
the pointer copy, so a query never observes a torn (graph, ranks) pair.

``generation`` increments on every publish and is the serving system's
logical clock; ``last_seq`` records the newest ingest event folded into
the snapshot.  A PPR walk index, when the engine keeps one, rides in the
same snapshot, so index queries see the graph the ranks were solved on.

Checkpointing reuses ``ft.checkpoint`` (atomic manifest + rename, the
reference's format): (ranks, generation, last_seq) every ``ckpt_every``
generations.  The graph itself is not checkpointed: restart replays the
event log up to ``last_seq`` (``launch/serve.py`` does this), the same
replay-from-stream contract as ``launch/pagerank.py``.  Nor is the PPR
walk index: its sampling is a pure function of (graph, config seed), so
the restarted engine rebuilds it bit for bit from the replayed graph.
"""
from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import torch

from repro_torch.device import DeviceLike
from repro_torch.ft.checkpoint import CheckpointManager
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
    """Front-buffer snapshot holder with optional periodic checkpoints."""

    def __init__(self, ckpt_dir: Optional[str] = None, ckpt_every: int = 10,
                 keep_last: int = 3):
        self._lock = threading.Lock()
        self._snap: Optional[Snapshot] = None
        self._next_gen = 0
        self._mgr = (CheckpointManager(ckpt_dir, every=max(1, ckpt_every),
                                       keep_last=keep_last)
                     if ckpt_dir else None)

    def seed_generation(self, generation: int):
        """Continue the generation clock from a restored checkpoint, so it
        stays monotone across restarts (the restored snapshot is
        re-published at its own generation)."""
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
        if self._mgr is not None:
            # gen 0 (the bootstrap snapshot) satisfies `gen % every == 0`,
            # so a restart never has to redo the cold static solve
            self._mgr.maybe_save(gen, self._ckpt_state(self._snap))
        return gen

    @staticmethod
    def _ckpt_state(snap: Snapshot) -> dict:
        return dict(ranks=snap.ranks,
                    generation=torch.tensor(snap.generation,
                                            dtype=torch.int64),
                    last_seq=torch.tensor(snap.last_seq, dtype=torch.int64))

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

    def restore_latest(self, num_vertices: int, device: DeviceLike = None):
        """(ranks, generation, last_seq) of the newest checkpoint, or None;
        the ranks land on ``device`` (default: the CUDA card)."""
        if self._mgr is None:
            return None
        meta = dict(device="meta")
        target = dict(
            ranks=torch.empty(num_vertices, dtype=torch.float64, **meta),
            generation=torch.empty((), dtype=torch.int64, **meta),
            last_seq=torch.empty((), dtype=torch.int64, **meta))
        _, state = self._mgr.restore_latest(target, device)
        if state is None:
            return None
        return (state["ranks"], int(state["generation"]),
                int(state["last_seq"]))
