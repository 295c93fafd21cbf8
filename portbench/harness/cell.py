"""One run of one cell: inputs from the seed, set-up, the window, the
metrics, and the judgement against the reference.  What is particular to
a configuration or a mix lives in its system and loop modules; this file
is the same for every cell."""
from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from harness import devtrace, inputs, judge
from harness.manifest import Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age_s() -> Optional[float]:
    """Seconds since this process started (Linux ``/proc``)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, device,
        limits: dict, overrides: Optional[dict] = None,
        extra_controls: tuple = (), t_start: float,
        log: Callable = _log) -> dict:
    """One run of ``cell``: its system (``systems/<system>.py``) driven by
    its mix's loop (``loops/<loop>.py``).  ``overrides`` go to the system
    (the program's own f32 path: ``polish=False``) and each of
    ``extra_controls`` judges the window's outputs once more with that
    control in the program's place."""
    dev = torch.device(device)
    gen = inputs.generator(seed, dev)
    sut = cell.system.System(cell.config, cell.traffic, seed, dev, overrides)
    plan = cell.loop.plan(sut, cell.traffic, seconds, gen)
    sut.build()
    log(sut.bootstrap())
    tr = sut.tracer()
    if trace:
        tr.start_tracing(capacity=1 << 20)
    opened = {}
    prof = {}

    def on_open():
        opened["setup_s"] = process_age_s()
        opened["t"] = time.perf_counter()
        sut.window_opened()
        if trace:
            tr.get_tracer().clear()
            if dev.type == "cuda":
                # device metrics come from the card's trace alone
                prof["p"] = devtrace.start()

    result = cell.loop.drive(sut, plan, cell.traffic, seconds=seconds,
                             on_open=on_open)
    spans = {}
    profile = None
    if trace:
        profile = devtrace.stop(prof["p"]) if prof else None
        t = tr.get_tracer()
        spans = {s: [x.dur for x in t.spans(s)] for s in sut.SPANS}
        tr.stop_tracing(write=False)
    setup_s = opened["setup_s"]
    if setup_s is None:
        setup_s = opened["t"] - t_start
    extra, summary = sut.window_record(result)
    record = dict(window_s=result["window_s"], setup_s=setup_s, trace=trace,
                  batches=result["batches"], answers=result["answers"],
                  spans=spans, profile=profile, **extra)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    nb = len(result["batches"])
    lat = [b["pub"] - b["sub"] for b in result["batches"]]
    qms = [a["done"] - a["start"] for a in result["answers"]]
    log(f"window: {result['window_s']:.3f} s, {nb} batches (update ms "
        f"median {1e3 * float(np.median(lat)) if lat else 0:.2f}), "
        f"{len(result['answers'])} queries (service ms mean "
        f"{1e3 * float(np.mean(qms)) if qms else 0:.3f}), {summary}; "
        f"set-up {setup_s:.3f} s; peak {peak / 2**30:.2f} GiB")
    for b in result["batches"]:
        if b.get("repacks"):
            log(f"repack in window batch {b['index']} at "
                f"{b['step']:.3f} s: step {1e3 * (b['pub'] - b['step']):.1f}"
                f" ms")
    if result["exhausted"]:
        log(f"warning: the feed ran out before {seconds} s; the window is "
            f"{result['window_s']:.3f} s")
    bad = forbidden_modules()
    if bad:
        raise ForbiddenImport(bad)
    outputs = sut.outputs()
    sut.close()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    numbers = sut.judge(plan, result, outputs)
    controls = {c: sut.judge(plan, result, outputs, control=c)
                for c in extra_controls}
    del outputs
    ok, rows = judge.verdict(numbers, limits)
    log(f"judged in {time.perf_counter() - t_judge:.1f} s "
        f"({numbers.get('answers_compared', 0)} answers compared)")
    metrics = {}
    for met in (cell.per_layer if trace else cell.end_to_end):
        v = met.read(record)
        if v is not None:
            metrics[met.name] = dict(value=v, unit=met.unit)
    out = dict(correct=bool(ok),
               attempted=nb + len(result["answers"]), failed=0,
               metrics=metrics,
               device=dict(platform="gpu" if dev.type == "cuda"
                           else dev.type,
                           kind=(torch.cuda.get_device_name(dev)
                                 if dev.type == "cuda" else dev.type),
                           count=1, memory_peak_bytes=int(peak)))
    if profile is not None:
        out["device"].update(busy_s=profile["busy_s"],
                             window_s=result["window_s"])
        ops = sorted(profile["kernels"].items(), key=lambda kv: -kv[1][0])
        gaps = sorted(profile["idle"].items(), key=lambda kv: -kv[1])
        out["breakdown"] = dict(
            device_ops=[[devtrace.short(n), s] for n, (s, _) in ops[:10]],
            idle_gaps=[[devtrace.short(n), s] for n, s in gaps[:10]])
    out["checks"] = {name: dict(value=v, limit=lim) for name, v, lim in rows}
    return dict(line=out, rows=rows, numbers=numbers, record=record,
                rebuilds=extra.get("repacks"), controls=controls)


class ForbiddenImport(RuntimeError):
    def __init__(self, names):
        super().__init__(f"the run loaded {names}")
        self.names = names
