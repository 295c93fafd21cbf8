"""End-to-end dynamic-PageRank streaming driver on the port, the paper's
workload (twin of ``repro.launch.pagerank``).

Replays a temporal stream (paper §5.1.4: 90% preload + consecutive
batches), maintains ranks with the chosen approach, checkpoints
(ranks, batch_idx) for restart, reports per-batch runtime, error and
work.  A restarted run restores the newest checkpoint, replays the graph
to its batch and goes on: its ranks equal an uninterrupted run's bit for
bit, since every sum of the f64 loop has a fixed order.

    PYTHONPATH=src python -m repro_torch.launch.pagerank \
        --dataset sx-mathoverflow --method frontier_prune --batches 20

Runs on the CUDA card unless ``--device cpu`` is given.  ``--mesh test``
replays the stream on a 2 x 2 test mesh (one card, or the CPU, repeats
its device) through the xla mesh engine; ``--mesh production`` needs the
reference's 256 cards.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.api import METHODS, update_pagerank
from repro_torch.core.reference import static_pagerank_ref
from repro_torch.data.snap import PAPER_TABLE1, load_temporal
from repro_torch.device import host_sync_count, resolve_device
from repro_torch.ft.checkpoint import CheckpointManager
from repro_torch.graph.dynamic import BatchUpdate, apply_batch, \
    make_batch_update
from repro_torch.graph.generators import TemporalStream
from repro_torch.graph.structure import EdgeListGraph, from_coo
from repro_torch.launch.mesh import resolve_mesh

# a batch's update for its index
BatchSource = Callable[[int], BatchUpdate]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def restore_stream(mgr: CheckpointManager, graph: EdgeListGraph,
                   batch_update: BatchSource):
    """(start batch, graph replayed to it, restored ranks), or (0, graph,
    None) when ``mgr``'s directory holds no checkpoint."""
    target = dict(
        ranks=torch.empty(graph.num_vertices, dtype=torch.float64,
                          device="meta"),
        batch_idx=torch.empty((), dtype=torch.int64, device="meta"))
    _, restored = mgr.restore_latest(target, graph.device)
    if restored is None:
        return 0, graph, None
    start = int(restored["batch_idx"])
    for i in range(start):           # replay graph structure to batch start
        graph = apply_batch(graph, batch_update(i))
    return start, graph, restored["ranks"]


def run_batches(graph: EdgeListGraph, ranks: torch.Tensor,
                batch_update: BatchSource, start: int, stop: int,
                method: str, *, mgr: Optional[CheckpointManager] = None,
                reference: Optional[Callable] = None, engine: str = "xla",
                packed=None, log: Callable = print, mesh=None):
    """The per-batch loop: batches [start, stop) applied one by one and
    the ranks updated with ``method``; each batch timed (apply + solve, to
    the end of the device's work), printed, and checkpointed through
    ``mgr``.  ``reference(i, graph)`` (batch i's f64 ranks, on the
    graph's device) adds the batch's L1 error.  ``engine="kernel"``
    maintains ``packed`` (the graph's ``PackedGraph``) with
    ``apply_batch_packed``.  ``mesh`` runs each update on the mesh
    engines (``update_pagerank(mesh=)``).

    Returns (graph, ranks, rows), one dict a batch in ``rows``."""
    rows: List[dict] = []
    for i in range(start, stop):
        upd = batch_update(i)
        syncs0 = host_sync_count()
        t0 = time.perf_counter()
        graph_new = apply_batch(graph, upd)
        kw = {}
        if engine == "kernel":
            from repro_torch.kernels.pagerank_spmv.update import \
                apply_batch_packed
            packed = apply_batch_packed(packed, upd)
            kw = dict(engine="kernel", packed=packed)
        r = update_pagerank(graph, graph_new, upd, ranks, method,
                            mesh=mesh, **kw)
        _sync(graph.device)
        dt = time.perf_counter() - t0
        row = dict(batch=i, ms=dt * 1e3, iterations=int(r.iterations),
                   affected=int(r.affected_ever.sum()),
                   edges=int(r.edges_processed),
                   host_syncs=host_sync_count() - syncs0)
        msg = (f"batch {i:3d}: {row['ms']:7.1f} ms  "
               f"iters={row['iterations']:3d}  "
               f"affected={row['affected']:,}  edges={row['edges']:,}")
        if reference is not None:
            row["l1"] = float((r.ranks - reference(i, graph_new)).abs()
                              .sum())
            msg += f"  L1err={row['l1']:.2e}"
        log(msg)
        rows.append(row)
        graph, ranks = graph_new, r.ranks
        if mgr is not None:
            mgr.maybe_save(i + 1, dict(
                ranks=ranks, batch_idx=torch.tensor(i + 1,
                                                    dtype=torch.int64)))
    return graph, ranks, rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="sx-mathoverflow",
                    choices=list(PAPER_TABLE1))
    ap.add_argument("--method", default="frontier_prune", choices=METHODS)
    ap.add_argument("--batch-frac", type=float, default=1e-3)
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_pr_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--check-error", action="store_true")
    ap.add_argument("--mesh", choices=["none", "test", "production"],
                    default="none",
                    help="replay the stream on a device mesh through the "
                         "mesh engine: 'test' = a 2x2 mesh (one card "
                         "repeats its device), 'production' = (16, 16)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mesh = resolve_mesh(args.mesh, device)
    if mesh is not None:
        print(f"mesh {mesh.shape} over {mesh.devices.size} positions")
    ds = load_temporal(args.dataset)
    print(f"dataset {ds.name}: |V|={ds.num_vertices:,} "
          f"|E_T|={len(ds.edges):,} synthetic={ds.synthetic}")
    stream = TemporalStream(ds.edges, ds.num_vertices, args.batch_frac,
                            args.batches)
    pre = stream.preload_edges()
    cap = len(pre) + stream.batch_size * stream.num_batches + 64
    graph = from_coo(pre[:, 0], pre[:, 1], ds.num_vertices,
                     edge_capacity=cap, device=device)
    print(f"preloaded {int(graph.num_valid_edges()):,} static edges; "
          f"{stream.num_batches} batches of {stream.batch_size}")

    def batch_update(i):
        return make_batch_update(np.zeros((0, 2)), stream.batch(i), 8,
                                 max(8, stream.batch_size), device=device)

    mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
    start, graph, ranks = restore_stream(mgr, graph, batch_update)
    if ranks is None:
        ranks = update_pagerank(graph, graph, None, None, "static",
                                mesh=mesh).ranks
    else:
        print(f"restored at batch {start}")

    def reference(i, g):
        live = g.valid.cpu().numpy()
        ref, _ = static_pagerank_ref(g.src.cpu().numpy()[live],
                                     g.dst.cpu().numpy()[live],
                                     ds.num_vertices, tol=1e-14)
        return torch.from_numpy(ref).to(device)

    run_batches(graph, ranks, batch_update, start, stream.num_batches,
                args.method, mgr=mgr,
                reference=reference if args.check_error else None,
                log=lambda msg: print(msg, flush=True), mesh=mesh)
    print("stream complete")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
