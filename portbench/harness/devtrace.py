"""The device's side of a traced window, from ``torch.profiler`` (CUPTI).

The profiler records the card's kernels, copies and memsets and the
host's CUDA runtime calls over the window.  ``summary`` reduces its
trace to:

  * ``busy_s``: the union of the intervals in which a kernel, copy or
    memset ran;
  * ``kernels``: {name: [seconds, launches]} over the window;
  * ``idle``: the gaps between busy intervals, each second labelled by
    the runtime call the host was in (``cudaLaunchKernel``,
    ``cudaMemcpyAsync``, ...) or ``host`` where it was in none, i.e. in
    Python and the libraries' own host code.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime",)


def start():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop(prof) -> dict:
    prof.__exit__(None, None, None)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return summary(events)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def summary(events) -> dict:
    dev, host = [], []
    kernels = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            if cat == "kernel":
                k = kernels[e.get("name", "?")]
                k[0] += dur * 1e-6
                k[1] += 1
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, e.get("name", "?")))
    busy = _union(dev)
    idle = defaultdict(float)
    host.sort()
    h = 0
    for (a0, a1), (b0, _) in zip(busy, busy[1:]):
        # gap (a1, b0): the time the host spent in each runtime call
        gap = b0 - a1
        covered = 0.0
        while h < len(host) and host[h][1] <= a1:
            h += 1
        j = h
        while j < len(host) and host[j][0] < b0:
            s, t, name = host[j]
            part = min(t, b0) - max(s, a1)
            if part > 0:
                idle[name] += part * 1e-6
                covered += part
            j += 1
        idle["host"] += max(0.0, gap - covered) * 1e-6
    return dict(busy_s=sum(b - a for a, b in busy) * 1e-6,
                kernels={k: v for k, v in kernels.items()},
                idle=dict(idle))


def short(name: str, width: int = 64) -> str:
    return name if len(name) <= width else name[:width]
