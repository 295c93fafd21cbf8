"""Exportable metrics: Prometheus text format, JSON lines, and a tiny
scrape server for the serving stack (a copy of ``repro.obs.export``:
host-only, the same text format byte for byte).

``prometheus_text`` renders any flat metrics dict (the shape
``ServeMetrics.as_dict`` produces) as Prometheus exposition format:
numeric values become gauges, nested dicts become labeled series
(``packed_rebuilds_by_shard`` → ``repro_packed_rebuilds_by_shard
{shard="3"} 2``), and non-numeric values are skipped.  Keys are assumed
snake_case (the ``as_dict`` contract) and are prefixed with ``repro_``.

``JsonlSink`` appends one JSON object per line — the machine-readable
feed for per-batch records (metrics snapshots, frontier-telemetry
trajectories) that a log shipper or notebook can tail.

``MetricsExporter`` ties both to a live ``ServeMetrics`` (+ optionally
the serve engine, for gauges that live on engine attributes: halo
occupancy, tuned geometry, comm accounting): ``scrape()`` returns the
Prometheus text, ``write(path)`` dumps it, and ``serve(port)`` runs a
daemon HTTP server answering ``GET /metrics`` (Prometheus) and
``GET /metrics.json`` (the raw dict) — ``port=0`` picks an ephemeral
port, exposed as ``.port`` for tests.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Callable, Optional

import numpy as np

__all__ = ["prometheus_text", "JsonlSink", "MetricsExporter"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(key: str, prefix: str) -> str:
    return prefix + _NAME_RE.sub("_", str(key))


def _num(v) -> Optional[float]:
    """Coerce to float if numeric (incl. numpy/bool), else None."""
    if isinstance(v, bool):
        return float(v)
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, (np.integer, np.floating)):
        return float(v)
    return None


def prometheus_text(metrics: dict, prefix: str = "repro_",
                    help_text: Optional[dict] = None) -> str:
    """Render a metrics dict as Prometheus exposition text (gauges).

    * numeric value → ``<prefix><key> <value>``
    * dict value    → one labeled sample per entry:
      ``<prefix><key>{key="<k>"} <value>`` (shard maps, per-phase times)
    * anything else → skipped (strings are descriptions, not samples)
    """
    lines = []
    for key in sorted(metrics):
        value = metrics[key]
        name = _metric_name(key, prefix)
        if isinstance(value, dict):
            samples = [(str(k), _num(v)) for k, v in sorted(value.items())]
            samples = [(k, v) for k, v in samples if v is not None]
            if not samples:
                continue
            if help_text and key in help_text:
                lines.append(f"# HELP {name} {help_text[key]}")
            lines.append(f"# TYPE {name} gauge")
            for k, v in samples:
                lines.append(f'{name}{{key="{k}"}} {v:g}')
            continue
        v = _num(value)
        if v is None:
            continue
        if help_text and key in help_text:
            lines.append(f"# HELP {name} {help_text[key]}")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {v:g}")
    return "\n".join(lines) + "\n"


class JsonlSink:
    """Append-only JSON-lines writer (one flush per record, so a killed
    serve process loses at most the in-flight line).

    ``max_bytes`` caps on-disk growth with logrotate-style rotation:
    when appending a line would push the file past the cap, the sink
    shifts ``path.1 -> path.2 -> ...`` (dropping ``path.<backups>``),
    renames ``path`` to ``path.1`` and starts fresh — a serve process
    left running for days keeps at most ``(backups + 1) * max_bytes``
    of telemetry.  ``backups=0`` truncates instead of keeping history.
    ``max_bytes=None`` (the default) preserves the unbounded append
    behaviour for short runs.
    """

    def __init__(self, path: str, clock=time.time,
                 max_bytes: Optional[int] = None, backups: int = 3):
        if max_bytes is not None and max_bytes < 1:
            raise ValueError("max_bytes must be positive (or None)")
        self.path = path
        self.max_bytes = max_bytes
        self.backups = backups
        self.rotations = 0
        self._clock = clock
        self._lock = threading.Lock()
        self._f = open(path, "a")
        self._size = self._f.tell()

    def write(self, record: dict, kind: Optional[str] = None) -> None:
        row = dict(record)
        if kind is not None:
            row["kind"] = kind
        row.setdefault("t", self._clock())
        line = json.dumps(row, default=_default) + "\n"
        with self._lock:
            if self._f.closed:
                return
            if (self.max_bytes is not None and self._size > 0
                    and self._size + len(line) > self.max_bytes):
                self._rotate_locked()
            self._f.write(line)
            self._f.flush()
            self._size += len(line)

    def _rotate_locked(self) -> None:
        self._f.close()
        if self.backups > 0:
            for i in range(self.backups - 1, 0, -1):
                src = f"{self.path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{i + 1}")
            os.replace(self.path, f"{self.path}.1")
        self._f = open(self.path, "w")
        self._size = 0
        self.rotations += 1

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


def _default(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return str(v)


class MetricsExporter:
    """Live exporter over a ``ServeMetrics`` (+ optional engine gauges).

    ``extra`` is a zero-arg callable returning a dict merged into every
    collection — the serve engine passes one exposing its
    engine-attribute gauges (halo occupancy, tuned geometry, comm info)
    so nothing reportable lives only on a Python object.
    """

    def __init__(self, metrics, extra: Optional[Callable[[], dict]] = None,
                 prefix: str = "repro_"):
        self.metrics = metrics
        self.extra = extra
        self.prefix = prefix
        self._httpd = None
        self._thread = None
        self.port: Optional[int] = None

    def collect(self) -> dict:
        d = dict(self.metrics.as_dict())
        if self.extra is not None:
            d.update(self.extra())
        return d

    def scrape(self) -> str:
        return prometheus_text(self.collect(), prefix=self.prefix)

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.scrape())
        return path

    # ---- scrape server ---------------------------------------------------
    def serve(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Start a daemon HTTP scrape server; returns the bound port.

        ``port=0`` binds an ephemeral port (read it from the return
        value or ``.port``), so parallel tests and co-located serve
        processes never collide.  Calling ``serve`` twice without a
        ``close`` in between is an error, and ``close`` is idempotent —
        the exporter also works as a context manager.
        """
        if self._httpd is not None:
            raise RuntimeError(
                f"exporter already serving on port {self.port}; "
                f"close() it first")
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):                          # noqa: N802
                if self.path.startswith("/metrics.json"):
                    body = json.dumps(exporter.collect(),
                                      default=_default).encode()
                    ctype = "application/json"
                elif self.path.startswith("/metrics"):
                    body = exporter.scrape().encode()
                    ctype = "text/plain; version=0.0.4"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):                 # quiet scrapes
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="metrics-exporter",
                                        daemon=True)
        self._thread.start()
        return self.port

    def close(self) -> None:
        """Stop the scrape server and release the port (idempotent)."""
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
            if self._thread is not None:
                self._thread.join(timeout=5.0)
            self._thread = None
            self.port = None

    def __enter__(self) -> "MetricsExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
