"""A closed-loop writer, with open-loop queries where the mix has them, in
one thread.  A mix names this module with ``"loop": "closed_writer"``.

``plan`` makes everything the window will send from the seed, before the
window: the system's inputs (``System.make_inputs``), the feed of the
mix's ``batch_events``-event batches, enough for ``max_batches_per_s``
batches a second (a headroom for the feed's length, which sizes nothing
in the program; a run that outruns it says so), and, with a ``queries``
section, the query arrivals and the warm-up's query vertices
(``harness/inputs.py``).

``drive`` warms up on the mix's ``warmup_batches`` batches of the feed
(each with a few queries in a mix that has them), then a synchronise.
The window opens and, batch after batch of the feed, the loop

  1. submits the batch's events through the ingest queue (deletions, then
     insertions, in the feed's order),
  2. calls the engine's step, which applies and publishes them,
  3. answers, oldest first, every query that has come due, including any
     that come due while it answers;

and stops starting batches once ``seconds`` have passed.  Queries that
came due before the window closed are then answered too.  The host clock
(``time.perf_counter``) times everything; a query is timed from when it
was due.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np

from harness import inputs

WARM_QUERIES_A_BATCH = 4


@dataclasses.dataclass
class Plan:
    feed: inputs.Feed
    queries: Optional[inputs.Queries]
    warm_vertices: Optional[np.ndarray]
    k: int


def plan(system, mix: dict, seconds: float, gen) -> Plan:
    warm = int(mix["warmup_batches"])
    n_batches = warm + int(math.ceil(seconds
                                     * float(mix["max_batches_per_s"])))
    n_ins = int(round(mix["batch_events"] * float(mix["insert_share"])))
    graph = system.make_inputs(gen, min_free=n_batches * n_ins)
    feed = inputs.feed(graph, mix, n_batches, gen)
    qspec = mix.get("queries")
    if not qspec:
        return Plan(feed, None, None, 10)
    qs = inputs.queries(graph, qspec, seconds + 5.0, gen)
    warm_v = inputs.warm_queries(graph, warm * WARM_QUERIES_A_BATCH, gen)
    return Plan(feed, qs, warm_v, int(qspec["k"]))


def drive(system, plan_: Plan, mix: dict, *, seconds: float,
          on_open: Callable[[], None], start: int = 0,
          warmup: Optional[int] = None, clock=time.perf_counter) -> dict:
    """Warm up on batches [start, start + warmup), then run the window
    from batch start + warmup on."""
    feed, qs, k = plan_.feed, plan_.queries, plan_.k
    warmup = int(mix["warmup_batches"]) if warmup is None else warmup
    for i, b in enumerate(range(start, start + warmup)):
        system.submit(feed.dels[b].tolist(), feed.ins[b].tolist())
        system.step()
        if qs is not None:
            for v in plan_.warm_vertices[i * WARM_QUERIES_A_BATCH:
                                         (i + 1) * WARM_QUERIES_A_BATCH]:
                system.query(int(v), k)
    system.sync()
    on_open()
    batches, answers = [], []
    due = qs.due_s if qs is not None else ()
    qi = 0
    t0 = clock()

    def answer(limit_s: float) -> None:
        nonlocal qi
        while qi < len(due) and due[qi] <= min(limit_s, clock() - t0):
            s = clock()
            a = system.query(int(qs.vertex[qi]), k)
            answers.append(dict(index=qi, vertex=int(qs.vertex[qi]),
                                due=float(due[qi]), start=s - t0,
                                done=clock() - t0, answer=a))
            qi += 1

    b = start + warmup
    exhausted = False
    while True:
        if b >= feed.batches:
            exhausted = True
            break
        dels, ins = feed.dels[b].tolist(), feed.ins[b].tolist()
        t_sub = clock()
        system.submit(dels, ins)
        t_step = clock()
        system.step()
        t_pub = clock()
        batches.append(dict(index=b, sub=t_sub - t0, step=t_step - t0,
                            pub=t_pub - t0, events=len(dels) + len(ins)))
        b += 1
        if qs is not None:
            answer(float("inf"))
        if clock() - t0 >= seconds:
            break
    t_end = clock() - t0
    if qs is not None:
        answer(t_end)
    system.sync()
    return dict(window_s=t_end, batches=batches, answers=answers,
                exhausted=exhausted, applied=b)
