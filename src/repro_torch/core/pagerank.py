"""DF* PageRank — the paper's five approaches on one f64 loop
(twin of ``repro.core.pagerank``).

  * ``static``     — power iteration from 1/|V| (paper §3.1)
  * ``naive``      — ND: warm start, update every vertex (§3.3.1)
  * ``traversal``  — DT: reachable marking, update marked (§3.3.2)
  * ``frontier``   — DF: incremental frontier expansion (§4.1.1)
  * ``frontier_prune`` — DF-P: expansion + contraction, closed-form rank
                      update for the implicit self-loop (§4.1.2, Eq. 2)

Pull-based synchronous (Jacobi) updates, L∞ convergence at τ=1e-10 on f64
ranks, α=0.85, at most 500 iterations, frontier metric Δr / max(r_old,
r_new) with τ_f = τ_p = 1e-6 — the reference's semantics exactly.

Sync policy: the loop ends on data, so each iteration reads one boolean
(``delta > tol``) back to the host.  That keeps ``iterations`` equal to
the reference's; ``PageRankResult.host_syncs`` counts the reads, and
each read (and each pulse of ``reachability_mask``) is also recorded with
``device.note_host_syncs``.  ``telemetry=True`` stacks the iteration's
``obs.frontier`` row with that boolean, so the row comes back in the same
read (``PageRankResult.telemetry``: f64 ``[iters, 5]`` NumPy).

Summation order: each graph's edge slots are sorted by dst once
(``EdgeListGraph.pull_order``, cached with the graph, so a served batch
reuses the previous batch's order for its old graph), and every
iteration sums each vertex's in-edge terms in one fixed order over that
slot order (``kernels.pull_contrib``): chunks of at most ``PULL_CHUNK``
slots, each added in slot order from +0.0, then the chunks in order (a
vertex of at most ``PULL_CHUNK`` in-edges: its terms one at a time from
+0.0).  The CUDA kernel on the card and its
plain version on the CPU add in that order, so the ranks are the same bit
for bit from run to run, and equal on the card and on the CPU.  The
chunk plan is built once an order, with it.  The in-degrees are the
order's segment lengths, and the frontier pushes OR over its segments
(``push_or``): no count by dst issues an atomic.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import note_host_syncs
from repro_torch.graph.structure import EdgeListGraph
from repro_torch.kernels.pull_contrib.pull_contrib import PullOrder, \
    pull_contrib
from repro_torch.obs.frontier import read_row, telemetry_row

ALPHA = 0.85
TOL = 1e-10
FRONTIER_TOL = 1e-6
PRUNE_TOL = 1e-6
MAX_ITER = 500

F64 = torch.float64


class PageRankResult(NamedTuple):
    ranks: torch.Tensor               # f64[V]
    iterations: int                   # iterations executed
    delta: torch.Tensor               # f64[]   final L∞ change
    affected_ever: torch.Tensor       # bool[V] vertices ever marked affected
    edges_processed: torch.Tensor     # i64[]  Σ active in-edges
    vertices_processed: torch.Tensor  # i64[]  Σ active vertices
    host_syncs: int = 0               # device-to-host reads in the solve
    # f64[iters, 5] obs.frontier rows (NumPy) when asked, else None
    telemetry: Optional[np.ndarray] = None


def _contrib(order: PullOrder, ranks: torch.Tensor,
             inv_out_deg: torch.Tensor) -> torch.Tensor:
    """c[v] = Σ_{u∈in(v), u≠v} R[u]/d_u  (pull step; self-loop excluded),
    each vertex's terms summed in ``pull_contrib``'s fixed chunked order
    over the slots of ``order``."""
    return pull_contrib(order, ranks, inv_out_deg)


def _rank_update(ranks, contrib, inv_deg, c0, alpha, closed_form: bool):
    """DF vs DF-P rank formulas (Algorithm 1 lines 13-16).

    closed_form=False:  r = C0 + α (c + R[v]/d_v)     [self-loop as one term]
    closed_form=True:   r = (C0 + α c) / (1 - α/d_v)  [paper Eq. 2]
    """
    if closed_form:
        return (c0 + alpha * contrib) / (1.0 - alpha * inv_deg)
    return c0 + alpha * (contrib + ranks * inv_deg)


def _pagerank_loop(graph: EdgeListGraph,
                   init_ranks: torch.Tensor,
                   init_affected: torch.Tensor,
                   *,
                   alpha: float = ALPHA,
                   tol: float = TOL,
                   frontier_tol: float = FRONTIER_TOL,
                   prune_tol: float = PRUNE_TOL,
                   max_iter: int = MAX_ITER,
                   closed_form: bool = False,
                   prune: bool = False,
                   expand: bool = False,
                   track_affected: bool = True,
                   telemetry: bool = False) -> PageRankResult:
    """The one loop behind all five approaches.

    static/naive: affected = all True, expand = prune = False.
    traversal:    affected = reachable mask, expand = prune = False.
    DF:           expand = True.
    DF-P:         expand = prune = closed_form = True.
    """
    V = graph.num_vertices
    dev = graph.device
    inv_deg = 1.0 / graph.out_degree(include_self_loop=True).to(F64)
    c0 = (1.0 - alpha) / V
    # the order every iteration adds each vertex's terms in
    order = graph.pull_order()
    in_deg = (order.ptr[1:] - order.ptr[:-1]).to(torch.int64)
    zero = torch.zeros((), dtype=F64, device=dev)
    zero_i = torch.zeros((), dtype=torch.int64, device=dev)

    ranks = init_ranks.to(F64)
    affected = init_affected
    ever = init_affected
    # a fill, not an upload: no host sync
    delta = torch.full((), float("inf"), dtype=F64, device=dev)
    edges = zero_i
    verts = zero_i
    it = 0
    syncs = 0
    rows = []
    while it < max_iter:
        contrib = _contrib(order, ranks, inv_deg)
        r_new_all = _rank_update(ranks, contrib, inv_deg, c0, alpha,
                                 closed_form)
        r_new = torch.where(affected, r_new_all, ranks)
        dr = (r_new - ranks).abs()
        rel = dr / torch.maximum(torch.maximum(r_new, ranks),
                                 torch.full((), 1e-300, dtype=F64,
                                            device=dev))
        delta = torch.where(affected, dr, zero).max()

        new_affected = affected
        if prune:
            # Alg.1 line 19: prune v if relative change within τ_p
            new_affected = new_affected & ~(affected & (rel <= prune_tol))
        if expand:
            # Alg.1 line 22: expand to out-neighbours (and v itself, via
            # the implicit self-loop) if rel change > τ_f
            big = affected & (rel > frontier_tol)
            new_affected = new_affected | graph.push_or(big) | big

        edges = edges + torch.where(affected, in_deg, zero_i).sum()
        n_aff = affected.sum(dtype=torch.int64)
        verts = verts + n_aff
        row = None
        if telemetry:
            row = telemetry_row(n_aff, delta,
                                (new_affected & ~affected).sum(),
                                (affected & ~new_affected).sum(), n_aff,
                                F64)
        if track_affected:
            ever = ever | new_affected
        ranks, affected = r_new, new_affected
        it += 1
        syncs += 1
        note_host_syncs()
        if row is None:
            more = bool(delta > tol)
        else:                  # the row rides the same one read
            vals, more = read_row(row, delta > tol)
            rows.append(vals)
        if not more:
            break
    return PageRankResult(ranks, it, delta, ever, edges, verts, syncs,
                          np.asarray(rows, np.float64).reshape(-1, 5)
                          if telemetry else None)


# --------------------------------------------------------------------------
# Public approaches
# --------------------------------------------------------------------------

def static_pagerank(graph: EdgeListGraph, *, alpha: float = ALPHA,
                    tol: float = TOL, max_iter: int = MAX_ITER
                    ) -> PageRankResult:
    V = graph.num_vertices
    init = torch.full((V,), 1.0 / V, dtype=F64, device=graph.device)
    aff = torch.ones(V, dtype=torch.bool, device=graph.device)
    return _pagerank_loop(graph, init, aff, alpha=alpha, tol=tol,
                          max_iter=max_iter, track_affected=False)


def naive_dynamic_pagerank(graph: EdgeListGraph, prev_ranks: torch.Tensor,
                           *, alpha: float = ALPHA, tol: float = TOL,
                           max_iter: int = MAX_ITER) -> PageRankResult:
    aff = torch.ones(graph.num_vertices, dtype=torch.bool,
                     device=graph.device)
    return _pagerank_loop(graph, prev_ranks, aff, alpha=alpha, tol=tol,
                          max_iter=max_iter, track_affected=False)


def reachability_mask(graph_prev: EdgeListGraph, graph_new: EdgeListGraph,
                      seeds: torch.Tensor) -> torch.Tensor:
    """DT preprocessing: vertices reachable from seeds in Gᵗ⁻¹ ∪ Gᵗ, by
    frontier pulses of ``push_or`` until nothing new is reached (one host
    read per pulse)."""
    reach, frontier = seeds, seeds
    while True:
        nxt = graph_prev.push_or(frontier) | graph_new.push_or(frontier)
        new = nxt & ~reach
        reach, frontier = reach | new, new
        note_host_syncs()
        if not bool(new.any()):
            return reach


def dynamic_traversal_pagerank(graph_prev: EdgeListGraph,
                               graph_new: EdgeListGraph,
                               seeds: torch.Tensor,
                               prev_ranks: torch.Tensor, *,
                               alpha: float = ALPHA, tol: float = TOL,
                               max_iter: int = MAX_ITER) -> PageRankResult:
    """DT: mark everything reachable from update endpoints, then iterate."""
    aff = reachability_mask(graph_prev, graph_new, seeds)
    return _pagerank_loop(graph_new, prev_ranks, aff, alpha=alpha, tol=tol,
                          max_iter=max_iter)


def initial_affected(graph_prev: EdgeListGraph, graph_new: EdgeListGraph,
                     touched: torch.Tensor) -> torch.Tensor:
    """DF/DF-P initial marking (Alg.1 lines 4-6): the update endpoints and
    their out-neighbours in *both* snapshots (u ∈ out(u) by the implicit
    self-loop)."""
    return touched | graph_prev.push_or(touched) | graph_new.push_or(touched)


def dynamic_frontier_pagerank(graph_prev: EdgeListGraph,
                              graph_new: EdgeListGraph,
                              touched: torch.Tensor,
                              prev_ranks: torch.Tensor, *,
                              alpha: float = ALPHA, tol: float = TOL,
                              frontier_tol: float = FRONTIER_TOL,
                              max_iter: int = MAX_ITER) -> PageRankResult:
    """DF (the paper §4.1.1)."""
    aff = initial_affected(graph_prev, graph_new, touched)
    return _pagerank_loop(graph_new, prev_ranks, aff, alpha=alpha, tol=tol,
                          frontier_tol=frontier_tol, max_iter=max_iter,
                          expand=True)


def dynamic_frontier_prune_pagerank(graph_prev: EdgeListGraph,
                                    graph_new: EdgeListGraph,
                                    touched: torch.Tensor,
                                    prev_ranks: torch.Tensor, *,
                                    alpha: float = ALPHA, tol: float = TOL,
                                    frontier_tol: float = FRONTIER_TOL,
                                    prune_tol: float = PRUNE_TOL,
                                    max_iter: int = MAX_ITER
                                    ) -> PageRankResult:
    """DF-P (the paper §4.1.2): expansion + pruning + closed-form update."""
    aff = initial_affected(graph_prev, graph_new, touched)
    return _pagerank_loop(graph_new, prev_ranks, aff, alpha=alpha, tol=tol,
                          frontier_tol=frontier_tol, prune_tol=prune_tol,
                          max_iter=max_iter, expand=True, prune=True,
                          closed_form=True)
