"""Pure-NumPy oracle of the paper's Algorithm 1 (asynchronous schedule).

The port's own copy of ``repro.core.reference``: the ground truth the
engines and kernels are tested against.  It mirrors the paper's OpenMP implementation semantics exactly:
single rank vector, per-vertex in-place (asynchronous) updates in vertex
order, explicit self-loop semantics via d_v = out_deg+1, pull-based.

Because the JAX engine is synchronous (Jacobi), iterate sequences differ;
tests therefore compare *fixed points* (converged ranks) which are schedule
independent, plus exact L1 error targets vs a 1e-100-style reference.
"""
from __future__ import annotations

import numpy as np

ALPHA = 0.85
TOL = 1e-10
MAX_ITER = 500


def build_csr(src, dst, num_vertices):
    """in-CSR (by dst) and out-degree for pull-based updates."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    order = np.argsort(dst, kind="stable")
    s, d = src[order], dst[order]
    indptr = np.zeros(num_vertices + 1, np.int64)
    np.add.at(indptr, d + 1, 1)
    np.cumsum(indptr, out=indptr)
    out_deg = np.zeros(num_vertices, np.int64)
    np.add.at(out_deg, src, 1)
    return indptr, s, out_deg + 1      # implicit self-loop


def static_pagerank_ref(src, dst, num_vertices, alpha=ALPHA, tol=TOL,
                        max_iter=MAX_ITER):
    src = np.asarray(src)
    dst = np.asarray(dst)
    out_deg = np.zeros(num_vertices, np.int64)
    np.add.at(out_deg, src, 1)
    deg = out_deg + 1                       # implicit self-loop
    r = np.full(num_vertices, 1.0 / num_vertices)
    c0 = (1 - alpha) / num_vertices
    for it in range(max_iter):
        contrib = np.zeros(num_vertices)
        np.add.at(contrib, dst, r[src] / deg[src])
        r_new = c0 + alpha * (contrib + r / deg)
        delta = np.max(np.abs(r_new - r))
        r = r_new
        if delta <= tol:
            return r, it + 1
    return r, max_iter


def df_pagerank_ref(src_prev, dst_prev, src_new, dst_new, num_vertices,
                    prev_ranks, touched, alpha=ALPHA, tol=TOL,
                    frontier_tol=1e-6, prune_tol=1e-6, max_iter=MAX_ITER,
                    prune=False, closed_form=False):
    """Asynchronous DF / DF-P exactly per Algorithm 1."""
    def out_adj(src, dst):
        order = np.argsort(src, kind="stable")
        s, d = src[order], dst[order]
        indptr = np.zeros(num_vertices + 1, np.int64)
        np.add.at(indptr, s + 1, 1)
        np.cumsum(indptr, out=indptr)
        return indptr, d

    op_ptr, op_idx = out_adj(src_prev, dst_prev)
    on_ptr, on_idx = out_adj(src_new, dst_new)
    in_ptr, in_src, deg = build_csr(src_new, dst_new, num_vertices)

    r = np.array(prev_ranks, dtype=np.float64)
    affected = np.zeros(num_vertices, bool)
    for u in np.nonzero(touched)[0]:
        affected[u] = True                     # self-loop: u ∈ out(u)
        affected[op_idx[op_ptr[u]:op_ptr[u + 1]]] = True
        affected[on_idx[on_ptr[u]:on_ptr[u + 1]]] = True
    ever = affected.copy()
    c0 = (1 - alpha) / num_vertices

    for it in range(max_iter):
        delta = 0.0
        for v in np.nonzero(affected)[0]:
            ins = in_src[in_ptr[v]:in_ptr[v + 1]]
            c = np.sum(r[ins] / deg[ins])
            if closed_form:
                r_new = (c0 + alpha * c) / (1 - alpha / deg[v])
            else:
                r_new = c0 + alpha * (c + r[v] / deg[v])
            dr = abs(r_new - r[v])
            delta = max(delta, dr)
            rel = dr / max(r_new, r[v])
            if prune and rel <= prune_tol:
                affected[v] = False
            if rel > frontier_tol:
                affected[v] = True             # self-loop: v ∈ out(v)
                nbrs = on_idx[on_ptr[v]:on_ptr[v + 1]]
                affected[nbrs] = True
                ever[nbrs] = True
            r[v] = r_new          # asynchronous: visible immediately
        if delta <= tol:
            return r, it + 1, ever
    return r, max_iter, ever


def l1_error(ranks, reference):
    return float(np.sum(np.abs(np.asarray(ranks) - np.asarray(reference))))
