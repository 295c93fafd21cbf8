"""Online rank-serving driver on the port: replay a SNAP temporal stream as
a timed event feed against ``repro_torch.serve``, interleaving rank
queries (twin of ``repro.launch.serve``).

The first 90% of the temporal edges preload G⁰ (paper §5.1.4); the rest
arrive one event at a time through the ingest queue (optionally paced at
``--rate`` events/s), the engine micro-batches them, and every
``--query-every`` events a query burst (point ranks + top-k, and with
``--ppr-walks`` a personalized top-k) is served from the current snapshot.
Prints the metrics summary and ``serve complete``; exits non-zero if fewer
than ``--min-queries`` queries were served.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --dataset sx-mathoverflow --events 5000 --engine kernel \
        --ppr-walks 64

Runs on the CUDA card unless ``--device cpu`` is given.  The reference
driver's mesh, monitor, trace, metrics-export and checkpoint flags are not
ported yet.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.core.api import ENGINES, METHODS
from repro_torch.data.snap import PAPER_TABLE1, load_temporal
from repro_torch.device import resolve_device
from repro_torch.ppr import IndexConfig
from repro_torch.serve import IngestQueue, QueryClient, RankStore, \
    ServeEngine, ServeMetrics, preload_graph_and_feed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="sx-mathoverflow",
                    choices=list(PAPER_TABLE1))
    ap.add_argument("--method", default="frontier_prune", choices=METHODS)
    ap.add_argument("--engine", default="xla", choices=list(ENGINES),
                    help="rank-update engine: 'xla' (the f64 loop) or "
                         "'kernel' (frontier-gated SpMV kernel with "
                         "device-side PackedGraph maintenance and the "
                         "f32→f64 precision ladder)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the CPU)")
    ap.add_argument("--events", type=int, default=5000,
                    help="number of post-preload edge events to feed")
    ap.add_argument("--flush-size", type=int, default=64)
    ap.add_argument("--flush-interval-ms", type=float, default=50.0)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="event feed pacing in events/s (0 = unpaced)")
    ap.add_argument("--query-every", type=int, default=100,
                    help="issue a query burst every K submitted events")
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--static-fallback-frac", type=float, default=0.25)
    ap.add_argument("--ppr-walks", type=int, default=0,
                    help="maintain a PPR walk index with R walks/vertex "
                         "(0 = off); query bursts then include a "
                         "personalized top-k")
    ap.add_argument("--ppr-len", type=int, default=16,
                    help="walk-index max length L (with --ppr-walks)")
    ap.add_argument("--min-queries", type=int, default=0,
                    help="exit non-zero unless this many queries were served")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    ds = load_temporal(args.dataset)
    graph, events = preload_graph_and_feed(ds, args.events, device=device)
    print(f"dataset {ds.name}: |V|={ds.num_vertices:,} preload="
          f"{int(graph.num_valid_edges()):,} events={len(events):,} "
          f"method={args.method} engine={args.engine} device={device} "
          f"flush={args.flush_size}/{args.flush_interval_ms:g}ms")

    metrics = ServeMetrics()
    store = RankStore()
    ingest = IngestQueue(flush_size=args.flush_size,
                         flush_interval=args.flush_interval_ms * 1e-3,
                         device=device)
    ppr_cfg = (IndexConfig(num_walks=args.ppr_walks, max_len=args.ppr_len,
                           seed=args.seed)
               if args.ppr_walks > 0 else None)
    engine = ServeEngine(graph, ingest, store, metrics=metrics,
                         method=args.method, engine=args.engine,
                         static_fallback_frac=args.static_fallback_frac,
                         ppr_index=ppr_cfg)
    engine.bootstrap()
    client = QueryClient(store, ingest, metrics)
    rng = np.random.default_rng(args.seed)

    t0 = time.perf_counter()
    next_due = t0
    for i in range(len(events)):
        if args.rate > 0:                     # timed feed
            next_due += 1.0 / args.rate
            lag = next_due - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
        u, v = int(events[i, 0]), int(events[i, 1])
        metrics.record_admission(ingest.submit_insert(u, v) is not None)
        engine.step()                          # flush when size/deadline hit
        if args.query_every and (i + 1) % args.query_every == 0:
            verts = rng.integers(0, ds.num_vertices, size=4)
            client.get_ranks(verts)
            r = client.top_k(args.topk)
            ppr_note = ""
            if args.ppr_walks > 0:
                p = client.personalized_top_k(
                    [int(verts[0])], args.topk, mode="auto")
                ppr_note = f" ppr_top1={p.vertices[0]}"
            print(f"event {i + 1:6d}: gen={r.generation:5d} "
                  f"stale={r.staleness_events:4d}ev "
                  f"top1={r.vertices[0]} ({r.ranks[0]:.3e})"
                  f"{ppr_note}", flush=True)
    engine.drain()
    wall = time.perf_counter() - t0
    engine.close()

    m = metrics.as_dict()
    m["wall_s"] = wall
    m["feed_events_per_s"] = len(events) / wall if wall > 0 else 0.0
    snap = store.snapshot()
    print("metrics " + json.dumps(
        {k: (round(v, 3) if isinstance(v, float) else v)
         for k, v in m.items()}))
    print(f"final generation {snap.generation}, last_seq {snap.last_seq}, "
          f"queries served {m['queries_served']}")
    print("serve complete")
    if m["queries_served"] < args.min_queries:
        print(f"FAIL: served {m['queries_served']} < --min-queries "
              f"{args.min_queries}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
