"""Elastic rescaling and replica membership (twin of ``repro.ft.elastic``).

Checkpoints are device-agnostic host arrays (``ft/checkpoint.py``, the
reference's format) and the graph partition is a pure function of (V,
E_cap, mesh shape) (``graph/partition.py``), so rescaling is restoring
arrays onto the new layout and repartitioning.  ``rescale_state`` restores
the newest checkpoint onto new shardings (``launch.mesh.NamedSharding``);
``rescale_pagerank_state`` restores (ranks, batch_idx) and partitions the
graph for a new mesh; ``rescale_serving_state`` restores the layout
``serve.state.RankStore`` writes (ranks, generation, last_seq) from a
checkpoint of either package.

``ReplicaRoster`` is the membership half of elasticity for the read-
replica tier (``serve/replicate.py``): replicas join and leave at any
time, liveness is heartbeat-based against an injected clock, and the
roster answers "who is alive now" for failover candidate selection.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List

import torch

from repro_torch.device import DeviceLike, note_host_syncs
from repro_torch.ft import checkpoint as ckpt


def rescale_state(directory: str, target_abstract: Any,
                  new_shardings: Any):
    """(step, state) of the latest checkpoint restored onto
    ``new_shardings`` (a tree matching ``target_abstract`` of
    ``launch.mesh.NamedSharding``), or (None, None) when there is none."""
    step = ckpt.latest_step(directory)
    if step is None:
        return None, None
    state = ckpt.restore(directory, step, target_abstract,
                         shardings=new_shardings)
    return step, state


def rescale_pagerank_state(directory: str, graph, mesh,
                           dtype=torch.float32, device: DeviceLike = None):
    """Restore (ranks, batch_idx) and partition ``graph`` for ``mesh``.

    Returns (batch_idx, ranks, partitioned_graph), or (None, None,
    partitioned_graph) when no checkpoint exists.  The ranks are a
    ``dtype`` tensor on ``device`` (default: the mesh's first device);
    the partition is host NumPy (``graph/partition.py``) for the mesh's
    ``model`` x data shape.
    """
    from repro_torch.graph.partition import partition_graph
    from repro_torch.launch.mesh import data_axes
    step = ckpt.latest_step(directory)
    m = mesh.shape["model"]
    p = 1
    for a in data_axes(mesh):
        p *= mesh.shape[a]
    part = partition_graph(graph, m, p)
    if step is None:
        return None, None, part
    meta = dict(device="meta")
    target = dict(ranks=torch.empty(graph.num_vertices, dtype=dtype, **meta),
                  batch_idx=torch.empty((), dtype=torch.int64, **meta))
    dev = mesh.devices.flat[0] if device is None else device
    state = ckpt.restore(directory, step, target, dev)
    note_host_syncs()                      # the batch index's read
    return int(state["batch_idx"]), state["ranks"], part


def rescale_serving_state(directory: str, num_vertices: int,
                          dtype=torch.float64, device: DeviceLike = None):
    """Restore a ``RankStore`` checkpoint (either package's) onto
    ``device`` (default: the card).

    Returns (generation, last_seq, ranks) with the ranks a tensor on the
    device, or (None, None, None) when no checkpoint exists.  Corrupt
    checkpoints fall back to the previous retained step
    (``ckpt.restore_latest_valid``).
    """
    meta = dict(device="meta")
    target = dict(
        ranks=torch.empty(num_vertices, dtype=dtype, **meta),
        generation=torch.empty((), dtype=torch.int64, **meta),
        last_seq=torch.empty((), dtype=torch.int64, **meta))
    step, state = ckpt.restore_latest_valid(directory, target, device)
    if state is None:
        return None, None, None
    return (int(state["generation"]), int(state["last_seq"]),
            state["ranks"])


class ReplicaRoster:
    """Heartbeat-based membership for the read-replica tier.

    Thread-safe: replicas join/leave/beat from their own threads while the
    failover controller reads liveness.  Time is a clock reading passed by
    the caller, so a harness can drive membership on a logical clock.
    """

    def __init__(self, heartbeat_timeout: float = 1.0):
        self.heartbeat_timeout = heartbeat_timeout
        self._lock = threading.Lock()
        self._last_beat: Dict[str, float] = {}
        self.joins = 0
        self.leaves = 0

    def join(self, name: str, now: float) -> None:
        with self._lock:
            if name not in self._last_beat:
                self.joins += 1
            self._last_beat[name] = now

    def leave(self, name: str) -> None:
        with self._lock:
            if self._last_beat.pop(name, None) is not None:
                self.leaves += 1

    def beat(self, name: str, now: float) -> None:
        self.join(name, now)

    def members(self) -> List[str]:
        with self._lock:
            return sorted(self._last_beat)

    def alive(self, now: float) -> List[str]:
        """Members whose last beat is within the heartbeat timeout."""
        with self._lock:
            return sorted(n for n, t in self._last_beat.items()
                          if now - t <= self.heartbeat_timeout)

    def is_alive(self, name: str, now: float) -> bool:
        with self._lock:
            t = self._last_beat.get(name)
        return t is not None and now - t <= self.heartbeat_timeout
