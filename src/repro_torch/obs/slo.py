"""SLO objectives with multi-window burn-rate alerting (a copy of
``repro.obs.slo``: host-only).

An SLO here is "fraction of good events ≥ objective" over a rolling
window — e.g. 99% of batches publish under the latency ceiling, 99% of
shadow samples stay inside the error budget.  The *error budget* is
``1 - objective``; the **burn rate** over a window is::

    burn = (bad events / total events in window) / error_budget

so burn 1.0 exactly exhausts the budget if sustained, and burn 14.4
over an hour eats a 30-day budget in ~2 days — the classic SRE
multi-window multi-burn-rate alerting rule.  An alert fires only when
BOTH a long window and its short companion (long/12 by convention)
exceed the threshold: the long window gives significance, the short
window makes the alert reset quickly once the system recovers.

``SloTracker`` is deliberately tiny: a deque of (t, bad) samples
pruned to the longest window, exact counts per window (no buckets —
serving pushes a few dozen events/s at most), burn rates, and
edge-triggered ``BurnRateAlert``s.  ``SloSet`` groups the serving
objectives and renders everything as gauges for the existing
``MetricsExporter`` (``repro_slo_<name>_burn_<window>s`` etc.).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

__all__ = ["BurnRateAlert", "SloTracker", "SloSet"]

# (long_window_seconds, burn_rate_threshold) pairs; the short window is
# long/12.  Defaults are scaled for minutes-long serve runs rather than
# the 30-day SRE horizon — the *arithmetic* is identical.
DEFAULT_WINDOWS: Tuple[Tuple[float, float], ...] = (
    (60.0, 14.4), (300.0, 6.0))
SHORT_DIVISOR = 12.0


class BurnRateAlert(NamedTuple):
    slo: str                # tracker name
    long_window_s: float
    short_window_s: float
    burn_long: float
    burn_short: float
    threshold: float
    t: float


class SloTracker:
    """Rolling good/bad ledger for one objective."""

    def __init__(self, name: str, objective: float = 0.99,
                 windows: Sequence[Tuple[float, float]] = DEFAULT_WINDOWS,
                 min_events: int = 12, clock=time.monotonic):
        if not 0.0 < objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        self.name = name
        self.objective = objective
        self.budget = 1.0 - objective
        self.windows = tuple(windows)
        # significance gate: a window alerts only once it holds this
        # many samples, so the first (compile-heavy) batches of a run
        # cannot trip a burn alert on one bad event out of one
        self.min_events = min_events
        self._clock = clock
        self._horizon = max(w for w, _ in self.windows)
        self._events: deque = deque()     # (t, bad) with t monotone
        self.total = 0
        self.bad = 0

    def record(self, good: bool) -> None:
        now = self._clock()
        self._events.append((now, not good))
        self.total += 1
        self.bad += int(not good)
        cutoff = now - self._horizon
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()

    def counts(self, window_s: float) -> Tuple[int, int]:
        """(total, bad) events inside the trailing window."""
        cutoff = self._clock() - window_s
        total = bad = 0
        for t, is_bad in reversed(self._events):
            if t < cutoff:
                break
            total += 1
            bad += int(is_bad)
        return total, bad

    def burn_rate(self, window_s: float) -> float:
        total, bad = self.counts(window_s)
        if total == 0:
            return 0.0
        return (bad / total) / self.budget

    def evaluate(self) -> List[BurnRateAlert]:
        """Alerts currently firing (long AND short window over threshold)."""
        now = self._clock()
        alerts = []
        for long_w, thr in self.windows:
            short_w = long_w / SHORT_DIVISOR
            total, bad = self.counts(long_w)
            if total < self.min_events or total == 0:
                continue
            bl = (bad / total) / self.budget
            if bl < thr:
                continue
            bs = self.burn_rate(short_w)
            if bs >= thr:
                alerts.append(BurnRateAlert(self.name, long_w, short_w,
                                            bl, bs, thr, now))
        return alerts

    def gauges(self) -> dict:
        g = {f"slo_{self.name}_bad_total": float(self.bad)}
        for long_w, _ in self.windows:
            g[f"slo_{self.name}_burn_{int(long_w)}s"] = \
                self.burn_rate(long_w)
        return g


class SloSet:
    """The serving stack's SLOs as one evaluable group."""

    def __init__(self, trackers: Dict[str, SloTracker]):
        self.trackers = trackers
        # alert keys (slo, long_window) currently active, for
        # edge-triggered incident emission by the monitor
        self._active: set = set()

    @classmethod
    def serving(cls, *, latency_objective: float = 0.99,
                staleness_objective: float = 0.99,
                shadow_objective: float = 0.99,
                windows: Sequence[Tuple[float, float]] = DEFAULT_WINDOWS,
                min_events: int = 12, clock=time.monotonic) -> "SloSet":
        """The three objectives of DESIGN.md §12: publish latency,
        query-visible staleness (in events), shadow error budget."""
        mk = lambda name, obj: SloTracker(                            # noqa
            name, obj, windows, min_events=min_events, clock=clock)
        return cls({
            "latency": mk("latency", latency_objective),
            "staleness": mk("staleness", staleness_objective),
            "shadow": mk("shadow", shadow_objective),
        })

    def record(self, name: str, good: bool) -> None:
        self.trackers[name].record(good)

    def evaluate(self) -> List[BurnRateAlert]:
        """Newly-firing alerts since the previous evaluation (edges)."""
        firing = [a for t in self.trackers.values() for a in t.evaluate()]
        keys = {(a.slo, a.long_window_s) for a in firing}
        new = [a for a in firing
               if (a.slo, a.long_window_s) not in self._active]
        self._active = keys
        return new

    def gauges(self) -> dict:
        g: dict = {"slo_alerts_active": float(len(self._active))}
        for t in self.trackers.values():
            g.update(t.gauges())
        return g


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 100]); None on empty input."""
    if not values:
        return None
    xs = sorted(values)
    k = max(0, min(len(xs) - 1, int(round(q / 100.0 * len(xs) + 0.5)) - 1))
    return xs[k]
