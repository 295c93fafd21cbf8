"""Edge-event ingest: admission control + adaptive micro-batch coalescing.

Events (insert/delete of an edge) arrive one at a time from any thread;
the queue coalesces them into capacity-padded ``BatchUpdate``s for the
serve engine.  Flush policy is adaptive micro-batching: a batch is ready
when ``flush_size`` events are pending (throughput mode) *or* when the
oldest pending event has waited ``flush_interval`` seconds (tail-latency
bound for trickle traffic).  ``poll(force=True)`` drains regardless —
used at shutdown and by synchronous test drivers.

Coalescing is net-effect per edge: within one window the *last* event
for a given (u, v) wins (insert→delete cancels to a deletion, which
``apply_batch`` treats as a no-op if the edge never existed; the
reverse collapses to an insertion).  This is sound because
``apply_batch`` applies deletions before insertions and already ignores
deletes of absent edges and duplicate inserts.

Admission control: at most ``max_pending`` events may be queued; beyond
that ``submit`` sheds load by returning ``None`` (callers count rejects
via ``ServeMetrics.record_admission``), bounding both memory and the
staleness a slow engine can accumulate.

All ``BatchUpdate``s produced by one queue share the same capacities
and lie on the queue's ``device``.  (The port's twin of
``repro.serve.ingest``.)
"""
from __future__ import annotations

import threading
import time
from typing import List, NamedTuple, Optional

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.dynamic import BatchUpdate, make_batch_update

INSERT = "insert"
DELETE = "delete"


class EdgeEvent(NamedTuple):
    kind: str    # INSERT | DELETE
    u: int
    v: int
    seq: int     # global arrival index, monotone
    t: float     # arrival clock reading


class CoalescedBatch(NamedTuple):
    update: BatchUpdate
    num_events: int      # raw events consumed from the queue
    num_coalesced: int   # events cancelled by net-effect coalescing
    first_seq: int
    last_seq: int
    oldest_t: float      # arrival time of the oldest event in the batch


def coalesce_events(events: List[EdgeEvent], del_capacity: int,
                    ins_capacity: int,
                    device: DeviceLike = None) -> CoalescedBatch:
    """Net-effect coalescing: last event per (u, v) wins."""
    if not events:
        raise ValueError("cannot coalesce an empty window")
    last: dict = {}
    for ev in events:                      # arrival order — later wins
        last[(ev.u, ev.v)] = ev.kind
    dels = np.asarray([k for k, kind in last.items() if kind == DELETE],
                      np.int32).reshape(-1, 2)
    ins = np.asarray([k for k, kind in last.items() if kind == INSERT],
                     np.int32).reshape(-1, 2)
    upd = make_batch_update(dels, ins, del_capacity, ins_capacity,
                            device=device)
    return CoalescedBatch(
        update=upd,
        num_events=len(events),
        num_coalesced=len(events) - len(last),
        first_seq=events[0].seq,
        last_seq=events[-1].seq,
        oldest_t=events[0].t,
    )


class IngestQueue:
    """Thread-safe event queue with admission control and flush policy."""

    def __init__(self, flush_size: int = 256, flush_interval: float = 0.05,
                 max_pending: Optional[int] = None, start_seq: int = 0,
                 clock=time.monotonic, device: DeviceLike = None):
        if flush_size < 1:
            raise ValueError("flush_size must be >= 1")
        self.flush_size = flush_size
        self.device = resolve_device(device)
        self.flush_interval = flush_interval
        self.max_pending = (8 * flush_size if max_pending is None
                            else max_pending)
        # fixed BatchUpdate capacities: every batch has one shape
        self.capacity = max(8, flush_size)
        self._clock = clock
        self._lock = threading.Lock()
        self._pending: List[EdgeEvent] = []
        self._next_seq = start_seq
        self.start_seq = start_seq
        self.rejected = 0

    # ---- producer side ---------------------------------------------------
    def submit(self, kind: str, u: int, v: int) -> Optional[int]:
        """Enqueue one event; returns its seq, or None if load-shed."""
        if kind not in (INSERT, DELETE):
            raise ValueError(f"unknown event kind {kind!r}")
        with self._lock:
            if len(self._pending) >= self.max_pending:
                self.rejected += 1
                return None
            seq = self._next_seq
            self._next_seq += 1
            self._pending.append(EdgeEvent(kind, int(u), int(v), seq,
                                           self._clock()))
            return seq

    def submit_insert(self, u: int, v: int) -> Optional[int]:
        return self.submit(INSERT, u, v)

    def submit_delete(self, u: int, v: int) -> Optional[int]:
        return self.submit(DELETE, u, v)

    # ---- consumer side ---------------------------------------------------
    @property
    def latest_seq(self) -> int:
        """Seq of the newest accepted event (start_seq - 1 if none yet)."""
        with self._lock:
            return self._next_seq - 1

    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def poll(self, force: bool = False) -> Optional[CoalescedBatch]:
        """Take one micro-batch if the flush policy triggers, else None."""
        with self._lock:
            n = len(self._pending)
            if n == 0:
                return None
            due = (n >= self.flush_size or force or
                   (self._clock() - self._pending[0].t
                    >= self.flush_interval))
            if not due:
                return None
            window = self._pending[: self.flush_size]
            del self._pending[: self.flush_size]
        return coalesce_events(window, self.capacity, self.capacity,
                               device=self.device)
