"""CorrectnessMonitor: one object wiring sentinels, shadow verification,
the flight recorder and SLO burn-rate alerting into ``ServeEngine``
(twin of ``repro.obs.monitor``).

The engine calls exactly two hooks:

  * ``on_bootstrap(engine)`` after the generation-0 publish — binds the
    recorder to the engine's configuration and captures the bootstrap
    anchor (edge list + ranks + packed leaves);
  * ``on_batch(...)`` after every publish — runs the invariant
    sentinel (which also yields the rank digest), appends the batch to
    the flight-recorder ring, offers the snapshot to the shadow
    verifier, feeds the SLO ledgers, and forwards every gauge into
    ``ServeMetrics`` so the existing ``MetricsExporter`` renders the
    whole correctness surface with zero extra plumbing.

Incident flow: sentinel/shadow/SLO violations become ``Incident``
records on ``self.incidents``, each mirrored as a trace instant and
(optionally) a JSONL line.  The first *error*-severity incident
triggers an automatic flight-recorder ``dump()`` into
``config.incident_dir`` — the bundle that ``launch/replay.py`` then
re-executes bit-for-bit.  Dumps are rate-limited by
``max_incident_dumps`` so a persistent violation cannot fill a disk.

Host syncs: ``on_batch`` adds exactly one a batch, the sentinel's read
(the solve's final delta rides it, and the batch record's update
copies complete behind it), plus one a leaf on the batches that take
an anchor, plus, with ``shadow_background=False``, the shadow solve's
reads on the batches it samples.  Each is recorded where it happens
(``device.note_host_syncs``), so ``ServeMetrics.batch_host_syncs``
counts them.  A background shadow's reads happen on its own thread and
stream and count there.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import Counter
from typing import List, Optional, Sequence, Tuple

from repro_torch.obs import trace as obs_trace
from repro_torch.obs.recorder import FlightRecorder, stage_update
from repro_torch.obs.sentinel import (ERROR, Incident, InvariantSentinel,
                                      SentinelConfig)
from repro_torch.obs.shadow import ShadowVerifier
from repro_torch.obs.slo import DEFAULT_WINDOWS, SloSet

__all__ = ["MonitorConfig", "CorrectnessMonitor"]


@dataclasses.dataclass(frozen=True)
class MonitorConfig:
    sentinel: SentinelConfig = dataclasses.field(
        default_factory=SentinelConfig)
    # shadow verification
    shadow_every: int = 64            # sample every Kth batch (0 = off)
    shadow_l1_budget: float = 1e-4
    shadow_linf_budget: float = 1e-5
    shadow_background: bool = True
    # flight recorder
    recorder_capacity: int = 256
    anchor_every: int = 64
    incident_dir: Optional[str] = None
    max_incident_dumps: int = 4
    # SLO objectives (DESIGN.md §12)
    latency_slo_ms: float = 500.0     # per-batch publish latency ceiling
    staleness_slo_events: int = 512   # query-visible staleness ceiling
    latency_objective: float = 0.99
    staleness_objective: float = 0.99
    shadow_objective: float = 0.99
    slo_windows: Sequence[Tuple[float, float]] = DEFAULT_WINDOWS
    slo_min_events: int = 12          # significance gate per window


class CorrectnessMonitor:
    """Correctness half of ``repro.obs``, attached to one ServeEngine."""

    def __init__(self, config: Optional[MonitorConfig] = None,
                 sink=None, clock=time.time):
        self.config = config or MonitorConfig()
        cfg = self.config
        self._clock = clock
        self.sink = sink                     # optional obs.JsonlSink
        self.sentinel = InvariantSentinel(cfg.sentinel, clock=clock)
        self.shadow = (ShadowVerifier(
            every=cfg.shadow_every, l1_budget=cfg.shadow_l1_budget,
            linf_budget=cfg.shadow_linf_budget,
            background=cfg.shadow_background, clock=clock)
            if cfg.shadow_every > 0 else None)
        self.recorder = FlightRecorder(capacity=cfg.recorder_capacity,
                                       anchor_every=cfg.anchor_every)
        self.slos = SloSet.serving(
            latency_objective=cfg.latency_objective,
            staleness_objective=cfg.staleness_objective,
            shadow_objective=cfg.shadow_objective,
            windows=cfg.slo_windows, min_events=cfg.slo_min_events)
        self.incidents: List[Incident] = []
        self.last_bundle: Optional[str] = None
        self._dumps = 0
        self._shadow_seen = 0

    # ---- engine hooks ----------------------------------------------------
    def on_bootstrap(self, engine) -> None:
        snap = engine.store.snapshot()
        self.recorder.bind_engine(engine)
        self.recorder.record_anchor(snap.generation, snap.graph,
                                    snap.ranks, packed=engine._packed,
                                    last_seq=snap.last_seq)

    def on_batch(self, *, engine, batch, graph, result, method: str,
                 fallback: bool, latency_s: float, affected: int,
                 fault: Optional[dict] = None) -> None:
        cfg = self.config
        gen = engine.store.generation
        last_seq = int(batch.last_seq)
        # the update's host copies are queued first, so that the
        # sentinel's one read also waits for them
        update = stage_update(batch.update)
        digest, incidents = self.sentinel.observe(
            generation=gen, last_seq=last_seq, ranks=result.ranks,
            delta=result.delta, iterations=int(result.iterations),
            affected=affected, fallback=fallback)
        self.recorder.record_batch(
            generation=gen, batch=batch, graph=graph, ranks=result.ranks,
            method=method, fallback=fallback,
            iterations=int(result.iterations), digest=digest,
            packed=engine._packed, fault=fault, update=update)
        if self.shadow is not None:
            self.shadow.maybe_submit(gen, last_seq, graph, result.ranks)
            incidents += self.shadow.take_incidents()
            # fold completed samples into the shadow error budget
            n_new = self.shadow.samples - self._shadow_seen
            if n_new > 0:
                for rep in list(self.shadow.reports)[-n_new:]:
                    self.slos.record("shadow",
                                     rep.l1 <= cfg.shadow_l1_budget)
                self._shadow_seen = self.shadow.samples
        self.slos.record("latency",
                         latency_s * 1e3 <= cfg.latency_slo_ms)
        staleness = max(0, engine.ingest.latest_seq - last_seq)
        self.slos.record("staleness",
                         staleness <= cfg.staleness_slo_events)
        now = self._clock()
        for alert in self.slos.evaluate():
            incidents.append(Incident(
                "slo_burn", "warn", gen, last_seq, alert.burn_long,
                alert.threshold,
                f"SLO '{alert.slo}' burning its error budget at "
                f"{alert.burn_long:.1f}x over {alert.long_window_s:g}s "
                f"(short window {alert.burn_short:.1f}x)", now))
        self._handle(incidents, gen)
        m = engine.metrics
        for name, value in self.gauges().items():
            m.set_gauge(name, value)

    # ---- incident handling -----------------------------------------------
    def _handle(self, incidents: List[Incident], gen: int) -> None:
        if not incidents:
            return
        tr = obs_trace.get_tracer()
        for inc in incidents:
            self.incidents.append(inc)
            tr.instant("obs.incident", kind=inc.kind,
                       severity=inc.severity, generation=inc.generation,
                       value=inc.value, threshold=inc.threshold)
            if self.sink is not None:
                self.sink.write(inc.as_dict(), kind="incident")
        cfg = self.config
        first_error = next((i for i in incidents if i.severity == ERROR),
                           None)
        if (first_error is not None and cfg.incident_dir
                and self._dumps < cfg.max_incident_dumps):
            path = os.path.join(cfg.incident_dir,
                                f"incident_gen{gen:08d}")
            try:
                self.recorder.dump(path, end_gen=gen,
                                   incident=first_error.as_dict())
                self._dumps += 1
                self.last_bundle = path
                tr.instant("obs.incident_bundle", path=path)
            except Exception as e:   # recording must never kill serving
                tr.instant("obs.incident_bundle_failed", error=str(e))

    # ---- reporting -------------------------------------------------------
    def gauges(self) -> dict:
        g = dict(self.sentinel.gauges)
        if self.shadow is not None:
            g.update(self.shadow.gauges())
        g.update(self.slos.gauges())
        g["incidents_total"] = float(len(self.incidents))
        return g

    def summary(self) -> dict:
        by_kind = Counter(i.kind for i in self.incidents)
        out = dict(batches=self.sentinel.batches,
                   incidents_total=len(self.incidents),
                   incidents_by_kind=dict(by_kind),
                   incident_bundle=self.last_bundle)
        if self.shadow is not None and self.shadow.reports:
            last = self.shadow.reports[-1]
            out.update(shadow_samples=self.shadow.samples,
                       shadow_skipped=self.shadow.skipped,
                       shadow_l1=last.l1, shadow_linf=last.linf)
        return out

    def close(self) -> None:
        """Drain the shadow thread and collect its final incidents."""
        if self.shadow is not None:
            self.shadow.stop()
            tail = self.shadow.take_incidents()
            if tail:
                self._handle(tail, tail[-1].generation)
