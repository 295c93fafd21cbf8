"""repro_torch.obs — end-to-end observability for the serving stack (twin
of ``repro.obs``, with its names and public API).

Two halves (DESIGN.md §11 performance, §12 correctness):

**Performance** —
  * ``trace``    — a low-overhead, thread-safe span tracer with
    Chrome-trace-format export (``chrome://tracing`` / Perfetto) and the
    ``timeit`` micro-helper, the one host-timing idiom;
  * ``frontier`` — the per-iteration convergence-telemetry schema the
    f64 and kernel engine loops record when asked (``telemetry=True``):
    affected count, L∞ residual, frontier growth/prune, active work
    units per iteration as a compact ``[iters, k]`` array;
  * ``export``   — Prometheus-text and JSON-lines exporters plus a tiny
    scrape server over ``ServeMetrics``.

**Correctness** —
  * ``sentinel`` — per-batch invariant checks (rank mass,
    nonnegativity, residual, EWMA anomaly scores) and the bitwise rank
    digest; violations become structured ``Incident`` records;
  * ``shadow``   — sampled background verification of every Kth
    snapshot against the f64 reference solve (live DF-P drift);
  * ``recorder`` — a flight recorder (batch ring + checkpoint anchors)
    with deterministic bit-for-bit ``replay``;
  * ``slo``      — SLO objectives with multi-window burn-rate alerts;
  * ``monitor``  — ``CorrectnessMonitor``, the facade ``ServeEngine``
    drives (``ServeEngine(..., monitor=...)``).

Tracing and telemetry are **off by default and free when off**: the
global tracer is disabled (spans are shared no-op context managers, no
device syncs), and with ``telemetry`` off the loops launch and read
exactly what they do without it; with it on, each iteration's row rides
the loop's existing read, so it adds no host sync either.  The
correctness monitor is opt-in per engine and adds one host read per
batch (the sentinel's), plus the anchor copies; the shadow solve runs
off the hot path, on its own thread and CUDA stream.
"""
from repro_torch.obs.export import JsonlSink, MetricsExporter, prometheus_text
from repro_torch.obs.frontier import FIELDS as TELEMETRY_FIELDS
from repro_torch.obs.frontier import NUM_FIELDS as TELEMETRY_NUM_FIELDS
from repro_torch.obs.frontier import FrontierTelemetry
from repro_torch.obs.trace import (Tracer, get_tracer, set_tracer, span,
                             start_tracing, stop_tracing, traced, tracing,
                             timeit)
from repro_torch.obs.sentinel import (Incident, InvariantSentinel,
                                SentinelConfig, rank_digest)
from repro_torch.obs.shadow import ShadowReport, ShadowVerifier
from repro_torch.obs.slo import BurnRateAlert, SloSet, SloTracker
from repro_torch.obs.recorder import (BatchRecord, FlightRecorder, ReplayReport,
                                load_bundle, replay)
from repro_torch.obs.monitor import CorrectnessMonitor, MonitorConfig

__all__ = [
    "BatchRecord", "BurnRateAlert", "CorrectnessMonitor",
    "FlightRecorder", "FrontierTelemetry", "Incident",
    "InvariantSentinel", "JsonlSink", "MetricsExporter", "MonitorConfig",
    "ReplayReport", "SentinelConfig", "ShadowReport", "ShadowVerifier",
    "SloSet", "SloTracker", "Tracer", "TELEMETRY_FIELDS",
    "TELEMETRY_NUM_FIELDS", "get_tracer", "load_bundle",
    "prometheus_text", "rank_digest", "replay", "set_tracer", "span",
    "start_tracing", "stop_tracing", "traced", "tracing", "timeit",
]
