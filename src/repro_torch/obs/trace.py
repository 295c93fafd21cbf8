"""Low-overhead span tracing for the serving stack (twin of
``repro.obs.trace``).

One ``Tracer`` holds a bounded, thread-safe ring buffer of *complete*
spans (name, start, duration, thread, args) recorded against a
monotonic clock.  The API is deliberately tiny:

  * ``with tracer.span("fused_update_loop", seq=s): ...`` — a
    context-manager span; nesting is per-thread (each thread's spans
    land on its own Chrome-trace track and nest by interval
    containment, the format's native rule);
  * ``@traced("name")`` — decorator form of the same;
  * ``tracer.record(name, t0, dur, **args)`` — an already-measured
    interval (used when a span's start must precede work whose outcome
    decides whether to record at all, e.g. an ingest poll that may
    yield no batch);
  * ``tracer.instant(name, **args)`` / ``tracer.counter(name, **vals)``
    — point annotations and counter tracks;
  * ``tracer.sync(x)`` — waits for the card's current stream *only when
    tracing is enabled*, so spans around device work get honest
    durations without perturbing the untraced hot path.  Each such wait
    synchronizes the host with the card and is recorded with
    ``device.note_host_syncs`` (on the CPU too, so the count is the
    same there).

Disabled tracers are free: ``span`` returns a shared no-op context
manager, nothing is allocated, nothing is locked, and — critically —
nothing forces a device sync, so with tracing off the serving hot path
makes exactly the launches and host syncs it makes untraced (tests
assert ``LAUNCH_COUNTS`` and ``batch_host_syncs`` are unchanged).

Export is Chrome trace format (the JSON array-of-events flavour):
``to_chrome()`` returns ``{"traceEvents": [...]}`` with complete-event
(``"ph": "X"``) records carrying ``name``/``ts``/``dur``/``pid``/
``tid``/``args`` in microseconds — loadable in ``chrome://tracing`` and
Perfetto as-is.  ``write(path)`` dumps it; round-tripping through
``json.loads`` is part of the tier-1 contract.

``timeit`` is the one timing idiom for host-side measurement (the
benchmarks use it instead of ad-hoc ``time.monotonic()`` pairs)::

    with timeit() as t:
        work()
    print(t.seconds)
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Iterator, List, Optional

import torch

from repro_torch.device import note_host_syncs

__all__ = [
    "Span", "Tracer", "timeit", "get_tracer", "set_tracer",
    "start_tracing", "stop_tracing", "tracing", "span", "traced",
]


class timeit:
    """Minimal elapsed-time context manager: ``with timeit() as t: ...``
    then read ``t.seconds``.  ``clock`` defaults to ``time.perf_counter``
    (monotonic, highest host resolution)."""

    __slots__ = ("_clock", "_t0", "seconds")

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self.seconds = 0.0

    def __enter__(self) -> "timeit":
        self._t0 = self._clock()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = self._clock() - self._t0


class Span:
    """One recorded interval (times in seconds on the tracer's clock)."""

    __slots__ = ("name", "t0", "dur", "tid", "args")

    def __init__(self, name: str, t0: float, dur: float, tid: int,
                 args: Optional[dict]):
        self.name = name
        self.t0 = t0
        self.dur = dur
        self.tid = tid
        self.args = args

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, t0={self.t0:.6f}, "
                f"dur={self.dur * 1e3:.3f}ms)")


class _NopSpan:
    """Shared do-nothing context manager for disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOP = _NopSpan()


class _LiveSpan:
    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = self._tracer.now()
        return self

    def __exit__(self, *exc):
        t = self._tracer
        t.record(self._name, self._t0, t.now() - self._t0,
                 **(self._args or {}))
        return False


class Tracer:
    """Thread-safe ring buffer of spans with Chrome-trace export.

    ``capacity`` bounds memory: the buffer keeps the newest spans and
    silently drops the oldest (``dropped`` counts them), so a tracer
    left on for a long serve run cannot grow without bound.
    """

    def __init__(self, capacity: int = 65536, enabled: bool = True,
                 clock=time.perf_counter, pid: Optional[int] = None):
        self.enabled = enabled
        self.capacity = capacity
        self._clock = clock
        self._epoch = clock()
        self._buf: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.dropped = 0
        self.pid = os.getpid() if pid is None else pid

    # ---- clock -----------------------------------------------------------
    def now(self) -> float:
        """Seconds since the tracer's epoch (cheap even when disabled)."""
        return self._clock() - self._epoch

    # ---- recording -------------------------------------------------------
    def span(self, name: str, **args):
        """Context manager recording one complete span on this thread."""
        if not self.enabled:
            return _NOP
        return _LiveSpan(self, name, args or None)

    def record(self, name: str, t0: float, dur: float, **args) -> None:
        """Record an interval measured by the caller (tracer-clock t0)."""
        if not self.enabled:
            return
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped += 1
            self._buf.append(("X", name, t0, dur,
                              threading.get_ident(), args or None))

    def instant(self, name: str, **args) -> None:
        """Point annotation ("ph": "i") at the current time."""
        if not self.enabled:
            return
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped += 1
            self._buf.append(("i", name, self.now(), 0.0,
                              threading.get_ident(), args or None))

    def counter(self, name: str, **values) -> None:
        """Counter-track sample ("ph": "C"): numeric series over time."""
        if not self.enabled:
            return
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped += 1
            self._buf.append(("C", name, self.now(), 0.0,
                              threading.get_ident(), values))

    def sync(self, x) -> None:
        """Wait for the stream that computes ``x`` (a tensor, or a tuple
        of them) only when tracing is enabled, so spans around device
        work measure the work, not its launch — and the untraced hot
        path never syncs.  The wait is one recorded host sync."""
        if not self.enabled or x is None:
            return
        t = next((y for y in (x if isinstance(x, (tuple, list)) else (x,))
                  if isinstance(y, torch.Tensor)), None)
        if t is None:
            return
        note_host_syncs()
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()

    # ---- reading ---------------------------------------------------------
    def spans(self, name: Optional[str] = None) -> List[Span]:
        """Snapshot of recorded "X" spans (optionally filtered by name)."""
        with self._lock:
            rows = list(self._buf)
        return [Span(n, t0, dur, tid, args)
                for ph, n, t0, dur, tid, args in rows
                if ph == "X" and (name is None or n == name)]

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    # ---- export ----------------------------------------------------------
    def to_chrome(self) -> dict:
        """Chrome trace format: {"traceEvents": [...]} in microseconds."""
        with self._lock:
            rows = list(self._buf)
        events = []
        tids = {}
        for ph, name, t0, dur, tid, args in rows:
            tids.setdefault(tid, len(tids))
            ev = dict(name=name, ph=ph, ts=round(t0 * 1e6, 3),
                      pid=self.pid, tid=tids[tid], cat="repro")
            if ph == "X":
                ev["dur"] = round(dur * 1e6, 3)
            if args:
                ev["args"] = {k: _jsonable(v) for k, v in args.items()}
            events.append(ev)
        # thread-name metadata so Perfetto labels the tracks
        meta = [dict(name="thread_name", ph="M", pid=self.pid, tid=i,
                     args={"name": f"thread-{i}"})
                for i in sorted(tids.values())]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


def _jsonable(v):
    """Coerce numpy/torch scalars so the trace always json-serializes."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    try:
        return v.item()          # 0-d numpy array / tensor
    except Exception:
        return str(v)


# ---------------------------------------------------------------------------
# process-global tracer: disabled by default (zero overhead); the launch
# drivers enable it behind --trace
# ---------------------------------------------------------------------------

_TRACER = Tracer(enabled=False)
_TRACE_PATH: Optional[str] = None


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-global tracer; returns the previous one."""
    global _TRACER
    prev, _TRACER = _TRACER, tracer
    return prev


def start_tracing(path: Optional[str] = None,
                  capacity: int = 65536) -> Tracer:
    """Enable the global tracer (fresh buffer); remember ``path`` for
    ``stop_tracing`` to write the Chrome-trace JSON to."""
    global _TRACE_PATH
    _TRACE_PATH = path
    set_tracer(Tracer(capacity=capacity, enabled=True))
    return _TRACER


def stop_tracing(write: bool = True) -> Optional[str]:
    """Disable the global tracer; write the trace if a path was given."""
    global _TRACE_PATH
    tracer, path = _TRACER, _TRACE_PATH
    out = None
    if write and path is not None and tracer.enabled:
        out = tracer.write(path)
    tracer.enabled = False
    _TRACE_PATH = None
    return out


@contextmanager
def tracing(path: Optional[str] = None,
            capacity: int = 65536) -> Iterator[Tracer]:
    """``with tracing("t.json") as tr: ...`` — scoped global tracing."""
    prev = set_tracer(Tracer(capacity=capacity, enabled=True))
    try:
        yield _TRACER
    finally:
        if path is not None:
            _TRACER.write(path)
        set_tracer(prev)


def span(name: str, **args):
    """Span on the process-global tracer (no-op unless tracing is on)."""
    return _TRACER.span(name, **args)


def traced(name: Optional[str] = None):
    """Decorator: trace every call of ``fn`` as one span."""

    def wrap(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def inner(*a, **kw):
            tr = _TRACER
            if not tr.enabled:
                return fn(*a, **kw)
            with tr.span(label):
                return fn(*a, **kw)

        return inner

    return wrap
