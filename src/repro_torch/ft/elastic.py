"""Elastic rescaling and replica membership (twin of ``repro.ft.elastic``).

Checkpoints are device-agnostic host arrays (``ft/checkpoint.py``, the
reference's format), so rescaling the serving state is restoring them and
bootstrapping a ``ServeEngine`` on whatever device the new process has.
``rescale_serving_state`` restores the layout ``serve.state.RankStore``
writes (ranks, generation, last_seq) from a checkpoint of either package.
The reference's mesh paths (``rescale_state`` onto new shardings,
``rescale_pagerank_state`` onto a mesh) wait for the multi-GPU port and
raise.

``ReplicaRoster`` is the membership half of elasticity for the read-
replica tier (``serve/replicate.py``): replicas join and leave at any
time, liveness is heartbeat-based against an injected clock, and the
roster answers "who is alive now" for failover candidate selection.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List

import torch

from repro_torch.device import DeviceLike
from repro_torch.ft import checkpoint as ckpt


def rescale_state(directory: str, target_abstract: Any,
                  new_shardings: Any):
    raise NotImplementedError(
        "rescale_state(new_shardings=...): the multi-GPU port is not "
        "ported yet; restore onto one device with ft.checkpoint.restore")


def rescale_pagerank_state(directory: str, graph, mesh, dtype=None):
    raise NotImplementedError(
        "rescale_pagerank_state(mesh=...): the multi-GPU port is not "
        "ported yet")


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
