"""Per-batch invariant sentinels: cheap correctness checks (twin of
``repro.obs.sentinel``).

The serving engine publishes a new f64 rank vector every micro-batch;
this module checks, with ONE host read per batch, the invariants any
correct DF/DF-P fixed point must satisfy:

  * **mass**   — with the paper's implicit self-loop on every vertex
    there are no dangling vertices, so the true fixed point has
    ``sum(ranks) == 1``.  A converged solve with L∞ residual δ can be
    off by at most ``δ·V/(1-α)``, which bounds the honest tolerance;
    a rank corruption at a vertex the next frontier never touches (the
    DF blind spot) shows up here immediately and forever.
  * **nonnegativity / finiteness** — ranks are probabilities; a NaN or
    negative entry means the update rule itself was violated
    (f32-ladder underflow, bad maintenance, memory corruption).
  * **residual** — the solve claims convergence; its final L∞ delta
    must actually be ≤ the configured ceiling (``max_iter`` exits are
    the one legitimate way to land above the loop tolerance, and they
    deserve an incident).
  * **anomaly scores** — iteration count and affected-set size per
    batch are scored against an exponentially-weighted running
    baseline (EWMA mean/variance).  These are *warnings*: they catch
    "the stream changed shape" (event corruption, feed bugs, capacity
    cliffs) that no algebraic invariant sees.

The same launches also produce the **rank digest**: the int64 bit
pattern of every f64 rank folded into one position-weighted wrapping
sum, ``Σ bits[i]·(2i+1) mod 2^64``, read as a signed int64 — the
reference's digest bit for bit.  torch's int64 multiply and sum wrap on
overflow on the CPU and on the card alike; nothing here relies on C++
defining signed overflow, and the tests hold the wrap against
``repro``'s digest (CPU) and the CPU's (card).  Equal digests ⇒
bit-identical rank vectors (up to the vanishing probability of a
weighted-sum collision); the digest is what the flight recorder stores
and what replay diffs against, so "reproduced bit-for-bit" is a single
integer comparison per batch.

Digest, mass, min, all-finite (and the solve's final delta, when it is
still on the device) are stacked into one int64 tensor (the floats by
their bit patterns) and read back once: the sentinel's one host sync a
batch, recorded with ``device.note_host_syncs``.

Violations become structured ``Incident`` records (JSON-able via
``as_dict``), plus a trace instant on the global tracer; per-batch
gauges (mass error, min rank, anomaly z-scores) flow through
``ServeMetrics.set_gauge`` so the Prometheus exporter sees them.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import note_host_syncs

__all__ = ["Incident", "SentinelConfig", "InvariantSentinel",
           "rank_digest"]

# incident severities: "error" trips the flight-recorder dump,
# "warn" is recorded and exported but does not dump a bundle
ERROR = "error"
WARN = "warn"


def _digest(ranks: torch.Tensor) -> torch.Tensor:
    """0-d int64 on the ranks' device: the position-weighted wrapping
    sum of the f64 bit patterns (odd weights keep every position's
    contribution invertible mod 2^64)."""
    bits = ranks.to(torch.float64).contiguous().view(torch.int64)
    idx = torch.arange(bits.shape[0], dtype=torch.int64, device=bits.device)
    return (bits * (2 * idx + 1)).sum()


def _stats(ranks: torch.Tensor, delta=None) -> torch.Tensor:
    """int64 [4] or [5] on the ranks' device: digest, the bits of
    sum(r) and min(r), all-finite, and the bits of ``delta`` if given."""
    r = ranks.to(torch.float64)
    f64 = lambda x: x.to(torch.float64).reshape(()).view(torch.int64)  # noqa
    parts = [_digest(r), f64(r.sum()), f64(r.min()),
             torch.isfinite(r).all().to(torch.int64)]
    if delta is not None:
        parts.append(f64(delta))
    return torch.stack(parts)


def _read(stats: torch.Tensor) -> np.ndarray:
    """The stacked stats on the host: one read."""
    note_host_syncs()
    return stats.cpu().numpy()


def rank_digest(ranks: torch.Tensor) -> int:
    """int64 digest of the exact bit pattern of an f64 rank vector."""
    note_host_syncs()
    return int(_digest(ranks).item())


@dataclasses.dataclass(frozen=True)
class Incident:
    """One structured invariant violation (DESIGN.md §12 schema)."""

    kind: str          # e.g. "rank_mass", "shadow_l1", "slo_burn"
    severity: str      # "error" | "warn"
    generation: int    # snapshot generation the violation was seen at
    last_seq: int      # newest ingest seq folded into that snapshot
    value: float       # the measured quantity
    threshold: float   # the bound it violated
    message: str       # human-readable one-liner
    t: float           # wall-clock time of detection

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class SentinelConfig:
    """Tolerances for the per-batch invariant checks.

    ``mass_tol`` defaults to the loose end of the honest bound
    ``tol·V/(1-α)`` for the serving defaults (tol=1e-10, α=0.85): at
    V=1e6 that is ≈6.7e-4, so 1e-3 never false-positives on a converged
    solve while catching any single-vertex corruption ≳1e-3.
    """

    mass_tol: float = 1e-3
    residual_tol: float = 1e-6      # ceiling on the solve's final delta
    negative_tol: float = 0.0       # min rank must be >= -negative_tol
    anomaly_z: float = 8.0          # z-score that trips a warn incident
    anomaly_warmup: int = 16        # batches before anomaly scoring arms
    ewma_alpha: float = 0.1         # baseline update rate


class _Ewma:
    """EWMA mean/variance with a warmup gate; yields z-scores."""

    __slots__ = ("alpha", "mean", "var", "count")

    def __init__(self, alpha: float):
        self.alpha = alpha
        self.mean = 0.0
        self.var = 0.0
        self.count = 0

    def score(self, x: float) -> float:
        """z-score of ``x`` against the current baseline (0.0 during
        warmup), then folds ``x`` into the baseline."""
        z = 0.0
        if self.count > 0:
            sd = math.sqrt(max(self.var, 1e-12))
            z = abs(x - self.mean) / sd if self.count > 1 else 0.0
        diff = x - self.mean
        incr = self.alpha * diff
        self.mean += incr
        self.var = (1.0 - self.alpha) * (self.var + diff * incr)
        self.count += 1
        return z


class InvariantSentinel:
    """Per-batch invariant checks over the published snapshot.

    ``observe`` returns ``(digest, incidents)``; gauges land in
    ``self.gauges`` (a plain dict the monitor forwards to
    ``ServeMetrics``) and a trace instant is emitted per incident.
    """

    def __init__(self, config: Optional[SentinelConfig] = None,
                 clock=time.time):
        self.config = config or SentinelConfig()
        self._clock = clock
        self._iters = _Ewma(self.config.ewma_alpha)
        self._affected = _Ewma(self.config.ewma_alpha)
        self.batches = 0
        self.trips = 0
        self.gauges: dict = {}

    def observe(self, *, generation: int, last_seq: int,
                ranks: torch.Tensor,
                delta: Union[float, torch.Tensor], iterations: int,
                affected: int, fallback: bool
                ) -> Tuple[int, List[Incident]]:
        """``delta`` may be the solve's 0-d device tensor: it then rides
        the same one read as the digest and the rank statistics."""
        cfg = self.config
        dev_delta = delta if isinstance(delta, torch.Tensor) else None
        vals = _read(_stats(ranks, dev_delta))
        digest = int(vals[0])
        mass, rmin = (float(x) for x in vals[1:3].view(np.float64))
        finite = bool(vals[3])
        delta = (float(vals[4:5].view(np.float64)[0]) if dev_delta is not None
                 else float(delta))
        now = self._clock()
        incidents: List[Incident] = []

        def trip(kind, severity, value, threshold, message):
            incidents.append(Incident(kind, severity, int(generation),
                                      int(last_seq), float(value),
                                      float(threshold), message, now))

        if not finite:
            trip("rank_nonfinite", ERROR, float("nan"), 0.0,
                 "published ranks contain NaN/Inf")
        else:
            mass_err = abs(mass - 1.0)
            if mass_err > cfg.mass_tol:
                trip("rank_mass", ERROR, mass_err, cfg.mass_tol,
                     f"rank mass {mass:.12f} drifted from 1 by "
                     f"{mass_err:.3e}")
            if rmin < -cfg.negative_tol:
                trip("rank_negative", ERROR, rmin, -cfg.negative_tol,
                     f"negative rank {rmin:.3e} in published snapshot")
        if delta > cfg.residual_tol:
            trip("residual", ERROR, delta, cfg.residual_tol,
                 f"solve left L-inf residual {delta:.3e} above "
                 f"{cfg.residual_tol:.1e} (max_iter exit?)")
        # anomaly scoring: static-fallback batches are legitimately
        # shaped nothing like the dynamic baseline, so they neither
        # score nor pollute the EWMA
        z_it = z_af = 0.0
        if not fallback:
            armed = self._iters.count >= cfg.anomaly_warmup
            z_it = self._iters.score(float(iterations))
            z_af = self._affected.score(float(affected))
            if armed:
                if z_it > cfg.anomaly_z:
                    trip("anomaly_iterations", WARN, z_it, cfg.anomaly_z,
                         f"iteration count {iterations} is {z_it:.1f} "
                         f"sigma from the EWMA baseline "
                         f"{self._iters.mean:.1f}")
                if z_af > cfg.anomaly_z:
                    trip("anomaly_affected", WARN, z_af, cfg.anomaly_z,
                         f"affected-set size {affected} is {z_af:.1f} "
                         f"sigma from the EWMA baseline "
                         f"{self._affected.mean:.1f}")

        self.batches += 1
        self.trips += len(incidents)
        self.gauges = {
            "sentinel_rank_mass_err": abs(mass - 1.0) if finite
            else float("inf"),
            "sentinel_rank_min": rmin,
            "sentinel_residual": float(delta),
            "sentinel_anomaly_iterations_z": z_it,
            "sentinel_anomaly_affected_z": z_af,
            "sentinel_trips": float(self.trips),
        }
        return digest, incidents
