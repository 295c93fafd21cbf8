"""Serving counters: update latency, query-visible staleness, work.

Everything is recorded host-side (plain floats/ints appended to lists)
so the hot path never syncs the device beyond what the engine already
does, and ``as_dict`` reduces to the numbers the bench harness and the
CLI report:

  * ``update_latency_{p50,p99}_ms`` — wall time of one engine step
    (apply_batch + rank update + publish);
  * ``staleness_{p50,p99}_events`` — at each query, how many accepted
    events the served snapshot is behind the newest submitted one
    (freshness in *events*, the unit the paper's batch fractions use);
  * ``events_per_s`` — applied events over the span between the first
    and last completed batch;
  * ``affected_mean`` / ``iterations_mean`` — per-batch |affected| and
    solver iterations (the paper's work proxies);
  * ``edges_processed`` / ``vertices_processed`` — the engines'
    window-granular (kernel) or per-vertex (XLA) work counters summed
    over all batches, so serving cost is comparable across engines and
    mesh sizes in the same units as ``PageRankResult``;
  * ``packed_rebuilds`` (+ ``packed_rebuilds_by_shard`` on the sharded
    kernel path) — spill/overlay/budget overflow repacks, attributed to
    the shards that overflowed;
  * ``comm_bytes`` — per-iteration cross-shard wire traffic summed over
    all batches (halo exchange on the sharded kernel path; 0 single-pod)
    — the observable the boundary-exchange win shows up in;
  * ``host_syncs_per_batch`` — calls that synchronize the host with
    the card per micro-batch: reads of device values (one per solver
    iteration, whose loop ends on data, plus the step's own checks),
    boolean-mask selections and uploads from pageable memory
    (``serve/engine.py``);
  * admission/fallback/coalescing counters.

The port's copy of ``repro.serve.metrics``; it counts host syncs where
the reference counts compiled device programs.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import List, Optional, Sequence

import numpy as np


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


class ServeMetrics:
    def __init__(self, clock=time.monotonic):
        self._clock = clock
        # per-batch
        self.update_latency_s: List[float] = []
        self.batch_events: List[int] = []
        self.batch_affected: List[int] = []
        self.batch_iterations: List[int] = []
        self.events_applied = 0
        self.events_coalesced = 0
        self.static_fallbacks = 0
        self.budget_carryover = 0   # batches seeded with a carried frontier
        self.walks_resampled = 0
        self.packed_rebuilds = 0   # kernel engine spill-overflow repacks
        self.packed_rebuilds_by_shard: Counter = Counter()
        self.edges_processed = 0
        self.vertices_processed = 0
        self.comm_bytes = 0
        self.batch_host_syncs: List[int] = []
        self._t_first_batch = None
        self._t_last_batch = None
        # queries
        self.query_staleness: List[int] = []
        self.queries_served = 0
        # admission
        self.accepted = 0
        self.rejected = 0
        # point-in-time gauges set by the owner (serve engine): values
        # that live on engine attributes — halo occupancy, tune-cache
        # hits, staleness-in-events — so as_dict is the ONE reporting
        # surface and the exporter never reaches into the engine
        self.gauges: dict = {}
        # per-batch frontier-telemetry digests (obs.frontier summaries);
        # recorded only when telemetry is on, so usually empty
        self.frontier_summaries: List[dict] = []

    # ---- recording -------------------------------------------------------
    def record_admission(self, accepted: bool):
        if accepted:
            self.accepted += 1
        else:
            self.rejected += 1

    def record_batch(self, latency_s: float, num_events: int,
                     num_coalesced: int, affected: int, iterations: int,
                     fallback: bool, walks_resampled: int = 0,
                     edges_processed: int = 0, vertices_processed: int = 0,
                     comm_bytes: int = 0, host_syncs: int = 0):
        now = self._clock()
        if self._t_first_batch is None:
            self._t_first_batch = now
        self._t_last_batch = now
        self.update_latency_s.append(float(latency_s))
        self.batch_events.append(int(num_events))
        self.batch_affected.append(int(affected))
        self.batch_iterations.append(int(iterations))
        self.events_applied += int(num_events)
        self.events_coalesced += int(num_coalesced)
        self.walks_resampled += int(walks_resampled)
        self.edges_processed += int(edges_processed)
        self.vertices_processed += int(vertices_processed)
        self.comm_bytes += int(comm_bytes)
        self.batch_host_syncs.append(int(host_syncs))
        if fallback:
            self.static_fallbacks += 1

    def record_packed_rebuild(self, shards: Optional[Sequence[int]] = None):
        """One overflow repack; ``shards`` names the overflowing shards
        on the sharded kernel path (None/empty = single-pod)."""
        self.packed_rebuilds += 1
        for s in shards or ():
            self.packed_rebuilds_by_shard[int(s)] += 1

    def record_budget_carryover(self):
        """One batch whose seed set folded in an unconverged frontier
        carried from a budget-capped previous batch."""
        self.budget_carryover += 1

    def record_query(self, staleness_events: int):
        self.queries_served += 1
        self.query_staleness.append(int(staleness_events))

    def set_gauge(self, name: str, value: float):
        """Set/overwrite a point-in-time gauge (snake_case name)."""
        self.gauges[str(name)] = float(value)

    def record_frontier(self, summary: dict):
        """One batch's frontier-telemetry digest
        (``FrontierTelemetry.summary()``)."""
        self.frontier_summaries.append(dict(summary))

    # ---- reduction -------------------------------------------------------
    def as_dict(self) -> dict:
        lat = self.update_latency_s
        span = ((self._t_last_batch - self._t_first_batch)
                if self._t_first_batch is not None else 0.0)
        # events/s needs a span; a single batch contributes its own latency
        denom = span if span > 0 else (lat[0] if lat else 0.0)
        out = dict(
            batches=len(lat),
            events_applied=self.events_applied,
            events_coalesced=self.events_coalesced,
            events_per_s=(self.events_applied / denom) if denom > 0 else 0.0,
            update_latency_p50_ms=_pct(lat, 50) * 1e3,
            update_latency_p99_ms=_pct(lat, 99) * 1e3,
            staleness_p50_events=_pct(self.query_staleness, 50),
            staleness_p99_events=_pct(self.query_staleness, 99),
            queries_served=self.queries_served,
            affected_mean=(float(np.mean(self.batch_affected))
                           if self.batch_affected else 0.0),
            iterations_mean=(float(np.mean(self.batch_iterations))
                             if self.batch_iterations else 0.0),
            static_fallbacks=self.static_fallbacks,
            budget_carryover=self.budget_carryover,
            walks_resampled=self.walks_resampled,
            edges_processed=self.edges_processed,
            vertices_processed=self.vertices_processed,
            comm_bytes=self.comm_bytes,
            host_syncs_per_batch=(
                float(np.mean(self.batch_host_syncs))
                if self.batch_host_syncs else 0.0),
            packed_rebuilds=self.packed_rebuilds,
            packed_rebuilds_by_shard={
                str(k): v
                for k, v in sorted(self.packed_rebuilds_by_shard.items())},
            admission_accepted=self.accepted,
            admission_rejected=self.rejected,
        )
        if self.frontier_summaries:
            fs = self.frontier_summaries
            out["frontier_batches"] = len(fs)
            out["frontier_iterations_mean"] = float(
                np.mean([s.get("iterations", 0) for s in fs]))
            out["frontier_affected_peak_mean"] = float(
                np.mean([s.get("affected_peak", 0.0) for s in fs]))
            out["frontier_residual_final"] = float(
                fs[-1].get("residual_final", 0.0))
        # gauges last, but core counters always win a name collision
        for k, v in sorted(self.gauges.items()):
            out.setdefault(k, v)
        return out
