"""Engine extensions on the same DF/DF-P loop (twin of
``repro.core.extensions``).

* **Personalized PageRank**: the teleport mass lands on a seed
  distribution p instead of uniformly, R = α·Aᵀ R + (1-α)·p.  Frontier
  logic is unchanged (rank-change propagation is topology-driven), so
  passing (prev_ranks, graph_prev, touched) gives incremental DF-P PPR.
  The exact path of ``QueryClient.personalized_top_k`` and the walk
  index's accuracy oracle.
* **Weighted PageRank**: per-edge weights w(u,v); contributions become
  R[u]·w(u,v)/W_out(u), with weight 1 on the implicit self-loop.

The loop reads one boolean back per iteration (``delta > tol``), as
``core.pagerank._pagerank_loop`` does, so iteration counts equal the
reference's; ``PageRankResult.host_syncs`` counts the reads.

Sums run in a fixed order, as in ``core.pagerank``: each solve sorts its
slots by dst once and sums each vertex's terms over them in
``kernels.pull_contrib``'s chunked order (chunks of at most
``PULL_CHUNK`` slots, each added in slot order from +0.0, then the chunks
in order; with the edge weights as per-slot weights), and the weighted
out-degree sums each vertex's out-edge weights the same way over a
src-sorted order (``segment_sum``).  The ranks are the same bit for bit from
run to run, and equal on the card and on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.pagerank import (ALPHA, F64, FRONTIER_TOL, MAX_ITER,
                                       PRUNE_TOL, TOL, PageRankResult,
                                       initial_affected)
from repro_torch.graph.structure import EdgeListGraph
from repro_torch.kernels.pull_contrib.pull_contrib import PullOrder, \
    pull_contrib, segment_sum, sorted_slots


def _generalized_loop(graph: EdgeListGraph,
                      init_ranks: torch.Tensor,
                      init_affected: torch.Tensor,
                      teleport: torch.Tensor,          # f64[V], sums to 1
                      edge_weight: Optional[torch.Tensor] = None,  # f64[E_cap]
                      *, alpha: float = ALPHA, tol: float = TOL,
                      frontier_tol: float = FRONTIER_TOL,
                      prune_tol: float = PRUNE_TOL, max_iter: int = MAX_ITER,
                      closed_form: bool = False, prune: bool = False,
                      expand: bool = False) -> PageRankResult:
    V = graph.num_vertices
    dev = graph.device
    zero = torch.zeros((), dtype=F64, device=dev)
    zero_i = torch.zeros((), dtype=torch.int64, device=dev)
    # the order every iteration adds each vertex's terms in: the graph's
    # own (cached) unweighted, and one with its permutation for the weights
    if edge_weight is None:
        order = graph.pull_order()
        w_out = graph.out_degree(include_self_loop=False).to(F64)
        slot_w = None                      # weight 1: r * 1.0 * inv == r * inv
    else:
        ptr, perm, keys = sorted_slots(graph.dst, graph.valid, V)
        order = PullOrder(ptr, graph.src[perm], keys)
        ptr_out, perm_out, _ = sorted_slots(graph.src, graph.valid, V)
        w_out = segment_sum(ptr_out, edge_weight[perm_out])
        slot_w = edge_weight[perm]
    in_deg = order.ptr[1:] - order.ptr[:-1]
    self_w = torch.ones(V, dtype=F64, device=dev)     # self-loop weight 1
    inv_w = 1.0 / (w_out + self_w)                     # incl. the self-loop
    base = (1.0 - alpha) * teleport
    in_deg = in_deg.to(torch.int64)
    tiny = torch.full((), 1e-300, dtype=F64, device=dev)

    ranks = init_ranks.to(F64)
    affected = ever = init_affected
    delta = torch.tensor(float("inf"), dtype=F64, device=dev)
    edges = verts = zero_i
    it = syncs = 0
    while it < max_iter:
        contrib = pull_contrib(order, ranks, inv_w, slot_w)
        if closed_form:
            r_new_all = (base + alpha * contrib) / (1.0 - alpha * self_w
                                                    * inv_w)
        else:
            r_new_all = base + alpha * (contrib + ranks * self_w * inv_w)
        r_new = torch.where(affected, r_new_all, ranks)
        dr = (r_new - ranks).abs()
        rel = dr / torch.maximum(torch.maximum(r_new, ranks), tiny)
        delta = torch.where(affected, dr, zero).max()
        new_affected = affected
        if prune:
            new_affected = new_affected & ~(affected & (rel <= prune_tol))
        if expand:
            big = affected & (rel > frontier_tol)
            new_affected = new_affected | graph.push_or(big) | big
        edges = edges + torch.where(affected, in_deg, zero_i).sum()
        verts = verts + affected.sum(dtype=torch.int64)
        ever = ever | new_affected
        ranks, affected = r_new, new_affected
        it += 1
        syncs += 1
        if not bool(delta > tol):
            break
    return PageRankResult(ranks, it, delta, ever, edges, verts, syncs)


def personalized_pagerank(graph: EdgeListGraph, seeds: torch.Tensor,
                          prev_ranks: Optional[torch.Tensor] = None,
                          graph_prev: Optional[EdgeListGraph] = None,
                          touched: Optional[torch.Tensor] = None,
                          **kw) -> PageRankResult:
    """PPR from a seed mask (bool[V]).  Static when prev_ranks is None;
    incremental DF-P update when (prev_ranks, graph_prev, touched) are
    given."""
    V = graph.num_vertices
    p = seeds.to(F64)
    p = p / p.sum().clamp(min=1e-300)
    if prev_ranks is None:
        return _generalized_loop(
            graph, p, torch.ones(V, dtype=torch.bool, device=graph.device),
            p, None, **kw)
    aff = initial_affected(graph_prev, graph, touched)
    return _generalized_loop(graph, prev_ranks, aff, p, None,
                             expand=True, prune=True, closed_form=True,
                             **kw)


def weighted_pagerank(graph: EdgeListGraph, edge_weight: torch.Tensor,
                      prev_ranks: Optional[torch.Tensor] = None,
                      graph_prev: Optional[EdgeListGraph] = None,
                      touched: Optional[torch.Tensor] = None,
                      **kw) -> PageRankResult:
    """Edge-weighted PageRank (DF-P incremental when warm inputs are
    given)."""
    V = graph.num_vertices
    uniform = torch.full((V,), 1.0 / V, dtype=F64, device=graph.device)
    if prev_ranks is None:
        return _generalized_loop(
            graph, uniform,
            torch.ones(V, dtype=torch.bool, device=graph.device), uniform,
            edge_weight, **kw)
    aff = initial_affected(graph_prev, graph, touched)
    return _generalized_loop(graph, prev_ranks, aff, uniform, edge_weight,
                             expand=True, prune=True, closed_form=True,
                             **kw)
