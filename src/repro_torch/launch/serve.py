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

With ``--ckpt-dir``, (ranks, generation, last_seq) checkpoints are
written every ``--ckpt-every`` generations; on restart the driver replays
events [0, last_seq] into the graph and resumes the feed from there: the
same replay-from-stream contract as ``launch/pagerank.py``.

``--trace PATH`` writes a Chrome-trace JSON of the run (span tracing and
per-iteration frontier telemetry; the rows land in
``PATH.frontier.jsonl``).  ``--metrics-port`` runs a Prometheus scrape
server, ``--metrics-path`` writes the final exposition text.
``--monitor`` turns on the correctness monitor (invariant sentinel,
shadow solve every ``--shadow-every`` batches, flight recorder, SLO
burn-rate alerts); ``--incident-dir D`` dumps a bundle there on the first
error-severity incident, which ``python -m repro_torch.launch.replay D/...``
re-executes bit for bit; ``--inject-fault GEN[:KIND[:VERTEX[:SCALE]]]``
arms a debug fault (both imply ``--monitor``).

Runs on the CUDA card unless ``--device cpu`` is given.  ``--mesh test``
serves on a 2 x 2 test mesh (one card, or the CPU, repeats its device;
the kernel engine shards its pack over the mesh's ``model`` axis),
``--mesh production`` on the reference's (16, 16) mesh, which needs 256
visible cards.  On the kernel engine the driver prints the pack geometry
the tuner picked (or ``--be``/``--vb``, which turn tuning off).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch import obs
from repro_torch.core.api import ENGINES, METHODS
from repro_torch.data.snap import PAPER_TABLE1, load_temporal
from repro_torch.device import resolve_device
from repro_torch.graph.dynamic import apply_batch, make_batch_update
from repro_torch.launch.mesh import resolve_mesh
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
                         "personalized top-k; combined with --mesh the "
                         "index is range-sharded over the mesh's model "
                         "axis and repaired per shard")
    ap.add_argument("--ppr-len", type=int, default=16,
                    help="walk-index max length L (with --ppr-walks)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="checkpoint every K generations (with --ckpt-dir)")
    ap.add_argument("--min-queries", type=int, default=0,
                    help="exit non-zero unless this many queries were served")
    ap.add_argument("--mesh", choices=["none", "test", "production"],
                    default="none",
                    help="serve on a device mesh: 'test' = a 2x2 mesh "
                         "(one card repeats its device), 'production' = "
                         "(16, 16); with --engine kernel the pack is "
                         "sharded over the mesh's model axis")
    ap.add_argument("--be", type=int, default=0,
                    help="kernel engine: fix the entry width (0 = tune)")
    ap.add_argument("--vb", type=int, default=0,
                    help="kernel engine: fix the window width (0 = tune)")
    ap.add_argument("--trace", default="",
                    help="write a Chrome-trace JSON of the serve run here "
                         "(enables span tracing + per-iteration frontier "
                         "telemetry; rows land in <PATH>.frontier.jsonl)")
    ap.add_argument("--metrics-port", type=int, default=-1,
                    help="run a Prometheus scrape server on this port "
                         "(0 = ephemeral, printed; -1 = off)")
    ap.add_argument("--metrics-path", default="",
                    help="write the final Prometheus exposition text here")
    ap.add_argument("--monitor", action="store_true",
                    help="enable correctness monitoring: invariant "
                         "sentinels, sampled shadow verification, flight "
                         "recorder, SLO burn-rate alerts (DESIGN.md §12)")
    ap.add_argument("--shadow-every", type=int, default=64,
                    help="shadow-verify every Kth micro-batch against "
                         "the f64 reference solve (0 = off)")
    ap.add_argument("--incident-dir", default="",
                    help="dump a replayable flight-recorder bundle here "
                         "on the first error-severity incident "
                         "(implies --monitor)")
    ap.add_argument("--inject-fault", default="",
                    help="DEBUG: corrupt the engine at a generation, as "
                         "GEN[:KIND[:VERTEX[:SCALE]]] with KIND rank|"
                         "event (e.g. 5:rank:0:4.0); implies --monitor")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mesh = resolve_mesh(args.mesh, device)
    ds = load_temporal(args.dataset)
    graph, events = preload_graph_and_feed(ds, args.events, device=device)
    print(f"dataset {ds.name}: |V|={ds.num_vertices:,} preload="
          f"{int(graph.num_valid_edges()):,} events={len(events):,} "
          f"method={args.method} engine={args.engine} device={device} "
          f"flush={args.flush_size}/{args.flush_interval_ms:g}ms")
    if mesh is not None:
        shards = (f" shards={mesh.shape['model']}"
                  if args.engine == "kernel" else "")
        print(f"mesh {mesh.shape}{shards}")

    metrics = ServeMetrics()
    store = RankStore(ckpt_dir=args.ckpt_dir or None,
                      ckpt_every=args.ckpt_every)
    restored = (store.restore_latest(ds.num_vertices, device)
                if args.ckpt_dir else None)
    start_event = 0
    if restored is not None:
        ranks, gen, last_seq = restored
        start_event = last_seq + 1
        if start_event > len(events):
            # the checkpointed ranks reflect events this run's feed does
            # not contain: replaying a truncated prefix would publish a
            # graph inconsistent with the restored ranks and last_seq
            print(f"FAIL: checkpoint last_seq={last_seq} exceeds the "
                  f"--events {args.events} feed; rerun with --events > "
                  f"{last_seq} (or a fresh --ckpt-dir)")
            return 1
        store.seed_generation(gen)             # gen clock survives restart
        if start_event > 0:         # replay the already-served prefix
            replay = events[:start_event]
            graph = apply_batch(graph, make_batch_update(
                np.zeros((0, 2)), replay, 8, max(8, len(replay)),
                device=device))
        print(f"restored generation {gen}; replayed {start_event} events")
    ingest = IngestQueue(flush_size=args.flush_size,
                         flush_interval=args.flush_interval_ms * 1e-3,
                         start_seq=start_event, device=device)
    ppr_cfg = (IndexConfig(num_walks=args.ppr_walks, max_len=args.ppr_len,
                           seed=args.seed)
               if args.ppr_walks > 0 else None)
    monitor = incident_sink = None
    if args.monitor or args.incident_dir or args.inject_fault:
        if args.incident_dir and args.trace:
            incident_sink = obs.JsonlSink(args.trace + ".incidents.jsonl")
        monitor = obs.CorrectnessMonitor(
            obs.MonitorConfig(shadow_every=args.shadow_every,
                              incident_dir=args.incident_dir or None),
            sink=incident_sink)
        print(f"correctness monitor on: shadow 1/{args.shadow_every}"
              + (f" incidents -> {args.incident_dir}"
                 if args.incident_dir else ""))
    kernel_opts = {k: v for k, v in (("be", args.be), ("vb", args.vb))
                   if v > 0}
    engine = ServeEngine(graph, ingest, store, metrics=metrics,
                         method=args.method, engine=args.engine, mesh=mesh,
                         kernel_opts=kernel_opts,
                         static_fallback_frac=args.static_fallback_frac,
                         ppr_index=ppr_cfg, monitor=monitor)
    if args.inject_fault:
        parts = args.inject_fault.split(":")
        engine.inject_fault(
            int(parts[0]),
            kind=parts[1] if len(parts) > 1 else "rank",
            vertex=int(parts[2]) if len(parts) > 2 else 0,
            scale=float(parts[3]) if len(parts) > 3 else 2.0)
        print(f"fault armed: {args.inject_fault}")
    sink = None
    if args.trace:
        obs.start_tracing(args.trace)
        sink = obs.JsonlSink(args.trace + ".frontier.jsonl")
        engine.telemetry_sink = sink
        print(f"tracing to {args.trace} "
              f"(frontier rows: {args.trace}.frontier.jsonl)")
    exporter = None
    if args.metrics_port >= 0 or args.metrics_path:
        exporter = obs.MetricsExporter(metrics)
        if args.metrics_port >= 0:
            port = exporter.serve(port=args.metrics_port)
            print(f"metrics: http://127.0.0.1:{port}/metrics")
    if restored is not None:
        engine.bootstrap(ranks=restored[0], last_seq=start_event - 1)
    else:
        engine.bootstrap()
    if engine.kernel_geometry is not None:
        info = engine.tune_info
        how = (f" ({info.source}, cache_hit={info.cache_hit}, "
               f"key={info.key} in {info.tune_time_s * 1e3:.1f}ms)"
               if info is not None else " (fixed)")
        print(f"kernel geometry: {engine.kernel_geometry.describe()}{how}")
    client = QueryClient(store, ingest, metrics)
    rng = np.random.default_rng(args.seed)

    t0 = time.perf_counter()
    next_due = t0
    for i in range(start_event, len(events)):
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
    engine.close()   # joins the shadow thread, flushes its mailbox
    if monitor is not None:
        print("monitor " + json.dumps(monitor.summary()))
        if incident_sink is not None:
            incident_sink.close()
    if args.trace:
        written = obs.stop_tracing()
        sink.close()
        print(f"trace written to {written}")
    if exporter is not None:
        if args.metrics_path:
            exporter.write(args.metrics_path)
            print(f"metrics written to {args.metrics_path}")
        exporter.close()

    m = metrics.as_dict()
    m["wall_s"] = wall
    m["feed_events_per_s"] = (len(events) - start_event) / wall \
        if wall > 0 else 0.0
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
