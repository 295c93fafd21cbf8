"""Sampled shadow verification: live measurement of DF-P pruning drift
(twin of ``repro.obs.shadow``).

DF-P trades exactness for work: pruned vertices keep slightly stale
ranks, and over thousands of micro-batches that error can compound in
ways the paper only measures offline.  The shadow verifier closes the
loop in production: every Kth published snapshot is re-solved *from
scratch* by the reference engine (the port's
``core.pagerank.static_pagerank``, f64, tol=1e-10 — the oracle every
parity test trusts) and the serving ranks are diffed against it:

  * ``l1``   — total variation-style drift, the paper's offline metric;
  * ``linf`` — worst single vertex, what a query actually returns.

The reference solve is orders of magnitude more expensive than a
micro-batch step, so it runs on a **background daemon thread** with a
depth-1 "latest wins" mailbox: if a new sample arrives while the
previous one is still solving, the stale pending sample is replaced
(``skipped`` counts them) — the hot path never blocks, and backlog can
never grow.  ``background=False`` solves synchronously (tests,
benchmarks that want determinism, and a sync count that must match the
card's: ``torch.cuda.set_sync_debug_mode`` counts every thread's syncs,
``device.note_host_syncs`` only the calling thread's).

On the card the background thread works on **its own CUDA stream**, so
its f64 solve never queues ahead of the hot path's next read.  At submit
the hot thread records an event on its current stream; the shadow
stream waits on it before it touches the snapshot.  The job holds the
snapshot's graph and ranks until the solve's last read has waited for
the shadow stream, so the caching allocator cannot hand their memory to
the hot path while the shadow still reads it.  The solve runs on
**clones** of the snapshot's edge tensors: it builds its own pull order,
chunk plan and out-degree count (``segment_ops/plan.py`` ``cached``,
whose table takes a lock, since both threads add and drop entries), and
nothing it caches is reachable from the hot path.

Divergence beyond the configured budgets produces ``Incident`` records
(drained by the ``CorrectnessMonitor``); every completed sample lands
in ``reports`` and the gauge dict regardless, so the exporter shows
the drift trajectory even while it is healthy.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional

import torch

from repro_torch.core import pagerank as pr
from repro_torch.device import note_host_syncs
from repro_torch.graph.structure import EdgeListGraph
from repro_torch.obs.sentinel import ERROR, Incident

__all__ = ["ShadowReport", "ShadowVerifier"]


class ShadowReport(NamedTuple):
    generation: int     # snapshot generation that was verified
    l1: float           # sum |serving - reference|
    linf: float         # max |serving - reference|
    mass_err: float     # |sum(reference) - 1| (reference sanity)
    iterations: int     # reference solve iterations
    solve_s: float      # reference solve wall time
    lag_batches: int    # batches published between submit and finish


class _Job(NamedTuple):
    generation: int
    last_seq: int
    graph: object       # EdgeListGraph snapshot (frozen)
    ranks: object       # served f64 ranks for the same generation
    submitted_at_count: int
    ready: object = None  # CUDA event after the ranks, on the hot stream


class ShadowVerifier:
    """Every-Kth-batch reference verification off the hot path."""

    def __init__(self, every: int = 64, l1_budget: float = 1e-4,
                 linf_budget: float = 1e-5, tol: float = 1e-10,
                 max_iter: int = 500, background: bool = True,
                 max_reports: int = 1024, clock=time.time):
        if every < 1:
            raise ValueError("every must be >= 1")
        self.every = every
        self.l1_budget = l1_budget
        self.linf_budget = linf_budget
        self.tol = tol
        self.max_iter = max_iter
        self.background = background
        self._clock = clock
        self.reports: deque = deque(maxlen=max_reports)
        self.samples = 0           # completed reference solves
        self.skipped = 0           # samples displaced by a newer one
        self._count = 0            # batches offered via maybe_submit
        self._incidents: List[Incident] = []
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: Optional[_Job] = None
        self._busy = False
        self._stopping = False
        self._thread: Optional[threading.Thread] = None
        self._stream = None       # the background thread's CUDA stream
        if background:
            self._thread = threading.Thread(target=self._loop,
                                            name="shadow-verifier",
                                            daemon=True)
            self._thread.start()

    # ---- hot-path side ---------------------------------------------------
    def maybe_submit(self, generation: int, last_seq: int, graph,
                     ranks) -> bool:
        """Offer one published snapshot; True if it was sampled.

        Fires on the first batch and every ``every`` batches after, so
        short streams still get at least one reference point.
        """
        take = (self._count % self.every) == 0
        self._count += 1
        if not take:
            return False
        ready = None
        if self.background and ranks.is_cuda:
            ready = torch.cuda.Event()
            ready.record()          # on the hot path's current stream
        job = _Job(int(generation), int(last_seq), graph, ranks,
                   self._count, ready)
        if not self.background:
            self._verify(job)
            return True
        with self._cond:
            if self._pending is not None:
                self.skipped += 1          # latest wins, backlog stays 0
            self._pending = job
            self._cond.notify()
        return True

    def take_incidents(self) -> List[Incident]:
        """Drain incidents produced since the last call (thread-safe)."""
        with self._lock:
            out, self._incidents = self._incidents, []
        return out

    def gauges(self) -> dict:
        with self._lock:
            last = self.reports[-1] if self.reports else None
        g = {"shadow_samples": float(self.samples),
             "shadow_skipped": float(self.skipped)}
        if last is not None:
            g.update(shadow_l1=last.l1, shadow_linf=last.linf,
                     shadow_lag_batches=float(last.lag_batches))
        return g

    # ---- verification ----------------------------------------------------
    def _verify(self, job: _Job) -> ShadowReport:
        if job.ready is None:
            return self._solve(job)
        if self._stream is None:
            self._stream = torch.cuda.Stream(job.ranks.device)
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(job.ready)
            return self._solve(job)

    def _solve(self, job: _Job) -> ShadowReport:
        t0 = self._clock()
        g = job.graph
        own = EdgeListGraph(
            src=g.src.clone(), dst=g.dst.clone(), valid=g.valid.clone(),
            num_vertices=g.num_vertices,
            num_edges=None if g.num_edges is None else g.num_edges.clone())
        ref = pr.static_pagerank(own, tol=self.tol, max_iter=self.max_iter)
        diff = (job.ranks.to(torch.float64) - ref.ranks).abs()
        note_host_syncs()                  # one read of the three sums
        l1, linf, mass_err = torch.stack([
            diff.sum(), diff.max(), (ref.ranks.sum() - 1.0).abs()]).tolist()
        rep = ShadowReport(job.generation, l1, linf, mass_err,
                           int(ref.iterations), self._clock() - t0,
                           self._count - job.submitted_at_count)
        now = self._clock()
        incs = []
        if l1 > self.l1_budget:
            incs.append(Incident(
                "shadow_l1", ERROR, job.generation, job.last_seq, l1,
                self.l1_budget,
                f"serving snapshot diverged from the f64 reference by "
                f"L1={l1:.3e} (budget {self.l1_budget:.1e})", now))
        if linf > self.linf_budget:
            incs.append(Incident(
                "shadow_linf", ERROR, job.generation, job.last_seq, linf,
                self.linf_budget,
                f"worst-vertex divergence {linf:.3e} exceeds "
                f"{self.linf_budget:.1e}", now))
        with self._lock:
            self.reports.append(rep)
            self.samples += 1
            self._incidents.extend(incs)
        return rep

    # ---- background thread -----------------------------------------------
    def _loop(self):
        while True:
            with self._cond:
                while self._pending is None and not self._stopping:
                    self._cond.wait()
                if self._stopping and self._pending is None:
                    return
                job, self._pending = self._pending, None
                self._busy = True
            try:
                self._verify(job)
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until no sample is pending or running; True if idle."""
        if not self.background:
            return True
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cond:
            while self._pending is not None or self._busy:
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0:
                    return False
                self._cond.wait(timeout=left)
        return True

    def stop(self, timeout: Optional[float] = None):
        """Drain the mailbox, finish in-flight work, join the thread.

        The worker loop only exits once ``_stopping`` is set AND the
        mailbox is empty, so a sample submitted just before shutdown is
        still verified (and its incidents recorded) before the join
        returns — a pending divergence is reported, never dropped.  The
        default join is unbounded: an abandoned daemon thread would die
        mid-solve at interpreter exit, which is exactly the silent-drop
        this guards against; pass ``timeout`` only if the caller can
        tolerate that.  Idempotent.
        """
        if self._thread is None:
            return
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise RuntimeError(
                "shadow-verifier thread did not drain within "
                f"{timeout}s; a pending sample may be unreported")
        self._thread = None
