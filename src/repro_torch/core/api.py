"""Unified entry point: ``update_pagerank`` — one call, five approaches
(twin of ``repro.core.api``), on one device or over a mesh.
"""
from __future__ import annotations

from typing import Literal, Optional

import torch

from repro_torch.core import pagerank as pr
from repro_torch.graph.dynamic import BatchUpdate, apply_batch, \
    touched_vertices_mask
from repro_torch.graph.structure import EdgeListGraph

Method = Literal["static", "naive", "traversal", "frontier", "frontier_prune"]
Engine = Literal["xla", "kernel"]

METHODS = ("static", "naive", "traversal", "frontier", "frontier_prune")
# "xla" keeps the reference's name for the plain f64 engine
ENGINES = ("xla", "kernel")

# per-method flags for the one `_pagerank_loop` behind all five approaches
LOOP_FLAGS = {
    "static": dict(track_affected=False),
    "naive": dict(track_affected=False),
    "traversal": dict(),
    "frontier": dict(expand=True),
    "frontier_prune": dict(expand=True, prune=True, closed_form=True),
}

# the same table for the kernel engine's loops, which have no
# track_affected knob (they always need affected_ever for the f64 polish)
KERNEL_FLAGS = {m: {k: v for k, v in f.items() if k != "track_affected"}
                for m, f in LOOP_FLAGS.items()}
for _f in KERNEL_FLAGS.values():          # kernel loop defaults expand=True
    _f.setdefault("expand", False)


def build_initial_state(graph_prev: EdgeListGraph,
                        graph_new: EdgeListGraph,
                        update: Optional[BatchUpdate],
                        prev_ranks: Optional[torch.Tensor],
                        method: Method) -> tuple:
    """Method → (init_ranks, init_affected): the paper's per-approach
    preprocessing (Alg.1 lines 1-6), shared by every engine.

    * ``static``     — cold start 1/|V|, everything affected;
    * ``naive``      — warm start, everything affected;
    * ``traversal``  — warm start, reachable from Δ endpoints;
    * ``frontier*``  — warm start, Δ endpoints + their out-neighbours in
                       Gᵗ⁻¹ ∪ Gᵗ.
    """
    V = graph_new.num_vertices
    dev = graph_new.device
    if method == "static":
        return (torch.full((V,), 1.0 / V, dtype=torch.float64, device=dev),
                torch.ones(V, dtype=torch.bool, device=dev))
    if prev_ranks is None:
        raise ValueError(f"method {method!r} needs prev_ranks")
    if method == "naive":
        return prev_ranks, torch.ones(V, dtype=torch.bool, device=dev)
    if update is None:
        raise ValueError(f"method {method!r} needs the batch update")
    touched = touched_vertices_mask(update, V)
    if method == "traversal":
        return prev_ranks, pr.reachability_mask(graph_prev, graph_new,
                                                touched)
    if method in ("frontier", "frontier_prune"):
        return prev_ranks, pr.initial_affected(graph_prev, graph_new,
                                               touched)
    raise ValueError(f"unknown method {method!r}")


# one distributed engine per (mesh, graph shape, method options);
# FIFO-bounded like the reference's cache
_DIST_ENGINES: dict = {}
_DIST_ENGINES_MAX = 8


def distributed_pagerank(graph_prev: EdgeListGraph,
                         graph_new: EdgeListGraph,
                         update: Optional[BatchUpdate],
                         prev_ranks: Optional[torch.Tensor],
                         method: Method,
                         mesh,
                         init_state: Optional[tuple] = None,
                         **kw) -> pr.PageRankResult:
    """``update_pagerank`` over a mesh on the xla engine
    (``dist.pagerank_dist.DistributedEngine``): the method's initial
    affected set (or ``init_state``, when the caller already built it),
    then the DF (or DF-P, for ``frontier_prune``) mesh loop to the shared
    fixed point.  Engines are cached per (mesh, shape, options)."""
    from repro_torch.dist.pagerank_dist import DistributedEngine
    V = graph_new.num_vertices
    ranks, affected = (init_state if init_state is not None else
                       build_initial_state(graph_prev, graph_new, update,
                                           prev_ranks, method))
    kw = {k: v for k, v in kw.items() if k != "telemetry"}
    prune = method == "frontier_prune"
    key = (mesh, V, graph_new.edge_capacity, prune,
           tuple(sorted(kw.items())))
    eng = _DIST_ENGINES.get(key)
    if eng is None:
        while len(_DIST_ENGINES) >= _DIST_ENGINES_MAX:
            _DIST_ENGINES.pop(next(iter(_DIST_ENGINES)))
        eng = _DIST_ENGINES.setdefault(key, DistributedEngine(
            mesh, V, graph_new.edge_capacity, prune=prune, **kw))
    r, it, delta, ever, edges, verts, syncs = eng.run(graph_new, ranks,
                                                      affected)
    return pr.PageRankResult(r, it, delta, ever, edges, verts, syncs)


def update_pagerank(graph_prev: EdgeListGraph,
                    graph_new: EdgeListGraph,
                    update: Optional[BatchUpdate],
                    prev_ranks: Optional[torch.Tensor],
                    method: Method = "frontier_prune",
                    mesh=None,
                    engine: Engine = "xla",
                    packed=None,
                    **kw) -> pr.PageRankResult:
    """Recompute ranks for Gᵗ given Gᵗ⁻¹, Δᵗ and Rᵗ⁻¹ with the chosen method.

    ``engine="xla"``: the f64 loop.  ``engine="kernel"``: the hybrid ladder
    (f32 frontier-gated SpMV iterations + f64 polish,
    ``core.kernel_engine``); ``packed`` supplies the blocked structure for
    streaming callers that maintain it incrementally, else it is packed
    here once.  Runs on the graph's device.  ``telemetry=True`` (in
    ``kw``) returns per-iteration ``obs.frontier`` rows in
    ``result.telemetry`` on either engine.

    ``mesh`` (a ``launch.mesh.Mesh`` with a ``model`` axis) runs the
    multi-device engines (``dist.pagerank_dist``): the xla engine's
    dst-range x edge-stripe loop, or with ``engine="kernel"`` the sharded
    kernel path, packed per call (streaming callers hold a
    ``ShardedKernelEngine``, as the serve engine does).
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; options {ENGINES}")
    if mesh is not None:
        from repro_torch.dist.pagerank_dist import _mesh_dims, \
            sharded_kernel_pagerank
        _mesh_dims(mesh)
        if engine == "kernel":
            if packed is not None:
                raise ValueError(
                    "packed= is the single-device structure; the sharded "
                    "path takes sharded=/spec= (streaming callers hold a "
                    "dist.ShardedKernelEngine, as the serve engine does)")
            init_ranks, init_affected = build_initial_state(
                graph_prev, graph_new, update, prev_ranks, method)
            return sharded_kernel_pagerank(graph_new, init_ranks,
                                           init_affected, mesh,
                                           **KERNEL_FLAGS[method], **kw)
        return distributed_pagerank(graph_prev, graph_new, update,
                                    prev_ranks, method, mesh, **kw)
    init_ranks, init_affected = build_initial_state(
        graph_prev, graph_new, update, prev_ranks, method)
    if engine == "kernel":
        from repro_torch.core.kernel_engine import hybrid_pagerank
        from repro_torch.kernels.pagerank_spmv.update import pack_graph
        if packed is None:
            # spill >= 1 guarantees every window owns an entry, so every
            # active window has a block the kernel writes (zeros included)
            packed = pack_graph(graph_new, spill_lanes_per_window=1)
        return hybrid_pagerank(graph_new, packed, init_ranks, init_affected,
                               **KERNEL_FLAGS[method], **kw)
    return pr._pagerank_loop(graph_new, init_ranks, init_affected,
                             **LOOP_FLAGS[method], **kw)


def step_stream(graph: EdgeListGraph, update: BatchUpdate,
                prev_ranks: torch.Tensor, method: Method = "frontier_prune",
                mesh=None, **kw):
    """One temporal-stream step: apply Δ, update ranks.  Returns (Gᵗ, result)."""
    graph_new = apply_batch(graph, update)
    res = update_pagerank(graph, graph_new, update, prev_ranks, method,
                          mesh=mesh, **kw)
    return graph_new, res
