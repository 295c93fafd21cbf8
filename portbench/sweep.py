#!/usr/bin/env python3
"""The query-rate sweep that fixes a serving mix's rate: one process,
one set-up, then one window a rate, the writer saturated throughout.

    python3 portbench/sweep.py --workload <name> --seed <n> \
        --seconds <s> --rates 100,200,400

A rate is sustained when the query backlog does not grow over its
window: the answers' lateness in the window's last third is at most 1.5
times that in its first third, the queries still waiting when the
window closes are fewer than those of two writer cycles, and the writer
published at least ten batches.  The cell's mix
then runs at four fifths of the highest sustained rate.  Needs the card;
not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

import run as command  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()
    command._environment()
    import torch
    from harness import inputs, manifest
    torch.set_num_threads(1)
    cell = manifest.find_cell(args.workload)
    mix = cell.traffic
    rates = [float(r) for r in args.rates.split(",")]
    dev = torch.device("cuda:0")
    gen = inputs.generator(args.seed, dev)
    sut = cell.system.System(cell.config, mix, args.seed, dev)
    # one feed for every rate's window
    plan = cell.loop.plan(sut, mix, args.seconds * len(rates), gen)
    g0 = sut.graph0
    graph = inputs.Graph(g0.src.to(dev), g0.dst.to(dev), g0.valid.to(dev),
                         g0.num_vertices, g0.num_edges)
    sets = [inputs.queries(graph, dict(mix["queries"], rate_per_s=rate),
                           args.seconds + 5.0, gen) for rate in rates]
    del graph
    sut.build()
    print(sut.bootstrap(), file=sys.stderr, flush=True)
    start, warmup = 0, None
    for rate, qs in zip(rates, sets):
        r = cell.loop.drive(sut, dataclasses.replace(plan, queries=qs), mix,
                            seconds=args.seconds, on_open=lambda: None,
                            start=start, warmup=warmup)
        start, warmup = r["applied"], 0
        late = np.array([a["done"] - a["due"] for a in r["answers"]])
        due = np.array([a["due"] for a in r["answers"]])
        w = r["window_s"]
        first = late[due < w / 3].mean() if (due < w / 3).any() else 0.0
        last = late[due >= 2 * w / 3].mean() if (due >= 2 * w / 3).any() \
            else 0.0
        waiting = int(sum(a["done"] > w for a in r["answers"]))
        nb = len(r["batches"])
        cycle = w / max(1, nb)
        # the writer must keep cycling too: a rate at which one step's
        # queries take the whole window starves it
        ok = (last <= 1.5 * max(first, 1e-9) and waiting < 2 * rate * cycle
              and nb >= 10)
        row = dict(rate=rate, batches=nb, answered=len(r["answers"]),
                   window_s=w, cycle_ms=1e3 * cycle,
                   late_first_ms=1e3 * first, late_last_ms=1e3 * last,
                   answer_p95_ms=1e3 * float(np.percentile(late, 95))
                   if len(late) else None,
                   update_p95_ms=1e3 * float(np.percentile(
                       [b["pub"] - b["sub"] for b in r["batches"]], 95)),
                   service_ms=1e3 * float(np.mean(
                       [a["done"] - a["start"] for a in r["answers"]]))
                   if r["answers"] else None,
                   waiting_at_close=waiting, sustained=bool(ok),
                   exhausted=r["exhausted"])
        print("SWEEP " + json.dumps(row), flush=True)
        if r["exhausted"]:
            break
    sut.close()


if __name__ == "__main__":
    main()
