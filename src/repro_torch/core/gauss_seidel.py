"""Window-sequential (block-Gauss-Seidel) PageRank (twin of
``repro.core.gauss_seidel``).

The paper's OpenMP engine is asynchronous: a vertex processed later in a
sweep reads ranks already updated earlier in the same sweep, which
converges faster than synchronous Jacobi.  The ``PackedGraph`` orders
edges by dst window, so the same benefit is available deterministically
at window granularity:

  sweep = the windows that own entries, in entry order; every entry of a
  window reads the ranks as they stood when the window began, then the
  window commits in closed form (paper Eq. 2); a window that owns no
  entry is never committed; the sweep's delta is the max over windows.

The reference is a ``lax.scan`` with no kernel; this is plain PyTorch, a
Python loop over the windows (a few launches a window).  Each window's
in-edge terms are summed per vertex by ``torch.segment_reduce`` over the
live lanes sorted by dst once a call (no float atomics), so sweeps are
bitwise equal run to run.  A window's old ranks are its ranks at the
start of the sweep (only its own commit changes them), so the delta is
one reduction a sweep.  Host syncs: three reads to plan the call (the
live-lane selection, the windows' entry and lane bounds) and one read a
sweep (``delta > tol``), each recorded with ``device.note_host_syncs``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.pagerank import ALPHA
from repro_torch.device import note_host_syncs
from repro_torch.graph.structure import EdgeListGraph
from repro_torch.kernels.pagerank_spmv.pagerank_spmv import PackedGraph

F32 = torch.float32


class GSResult(NamedTuple):
    ranks: torch.Tensor   # f32[V]
    sweeps: int
    delta: torch.Tensor   # f32[]


class _Plan(NamedTuple):
    src: torch.Tensor        # int64[L] live lanes' src, sorted by dst
    offsets: torch.Tensor    # int64[NW, VB+1] each window's segment offsets
    windows: list            # [(w, lane_lo, lane_hi)] committed, in order
    committed: torch.Tensor  # bool[NW*VB] vertices of committed windows


def _plan(packed: PackedGraph) -> _Plan:
    """The live lanes sorted by (window, dst_rel), stable (lane order
    within a vertex), and each committed window's lane range."""
    vb, nw, be = packed.vb, packed.num_windows, packed.be
    v_pad = nw * vb
    dev = packed.src.device
    note_host_syncs()                      # the selection reads its size
    lanes = torch.nonzero(packed.valid.reshape(-1) > 0).flatten()
    dst = (packed.window.long().repeat_interleave(be)[lanes] * vb
           + packed.dst_rel.reshape(-1)[lanes].long())
    dst, perm = torch.sort(dst, stable=True)
    src = packed.src.reshape(-1)[lanes[perm]].long()
    ptr = torch.zeros(v_pad + 1, dtype=torch.int64, device=dev)
    ptr[1:] = torch.cumsum(torch.bincount(dst, minlength=v_pad), 0)
    rows = ptr[:-1].view(nw, vb)
    offsets = torch.cat([rows, ptr[vb::vb].view(nw, 1)], 1) - rows[:, :1]
    note_host_syncs()
    starts = packed.entry_start.tolist()
    note_host_syncs()
    bounds = ptr[::vb].tolist()
    owns = [starts[w + 1] > starts[w] for w in range(nw)]
    windows = [(w, bounds[w], bounds[w + 1]) for w in range(nw) if owns[w]]
    committed = torch.tensor(owns, device=dev).repeat_interleave(vb)
    return _Plan(src, offsets, windows, committed)


def gauss_seidel_pagerank(graph: EdgeListGraph, packed: PackedGraph,
                          init_ranks: torch.Tensor, *,
                          alpha: float = ALPHA, tol: float = 1e-7,
                          max_sweeps: int = 500) -> GSResult:
    """Window-sequential sweeps to the DF-P closed-form fixed point (f32).

    ``graph`` supplies degrees; ``packed`` the window-ordered edges.
    """
    V, vb = graph.num_vertices, packed.vb
    v_pad = packed.num_windows * vb
    dev = graph.device
    deg = graph.out_degree(include_self_loop=True)
    inv_deg = torch.ones(v_pad, dtype=F32, device=dev)
    inv_deg[:V] = (1.0 / deg.to(torch.float64)).to(F32)
    a32 = torch.full((), alpha, dtype=F32, device=dev)
    c0 = torch.full((), (1.0 - alpha) / V, dtype=F32, device=dev)
    den = 1.0 - a32 * inv_deg
    plan = _plan(packed)

    ranks = torch.zeros(v_pad, dtype=F32, device=dev)
    ranks[:V] = init_ranks.to(F32)
    rinv = ranks * inv_deg                 # R[u]/d_u, kept fresh
    zero = torch.zeros((), dtype=F32, device=dev)
    empty = torch.zeros(vb, dtype=F32, device=dev)
    delta = torch.full((), float("inf"), dtype=F32, device=dev)
    sweeps = 0
    while sweeps < max_sweeps:
        start = ranks.clone()
        for w, lo, hi in plan.windows:
            sl = slice(w * vb, (w + 1) * vb)
            if hi > lo:
                # every lane reads the ranks as the window began
                contrib = torch.segment_reduce(
                    rinv[plan.src[lo:hi]], "sum", offsets=plan.offsets[w],
                    unsafe=True)
            else:
                contrib = empty
            # closed-form commit: (C0 + α c) / (1 - α/d_v)
            torch.div(c0 + a32 * contrib, den[sl], out=ranks[sl])
            torch.mul(ranks[sl], inv_deg[sl], out=rinv[sl])
        delta = torch.where(plan.committed, (ranks - start).abs(),
                            zero).max()
        sweeps += 1
        note_host_syncs()
        if not bool(delta > tol):
            break
    return GSResult(ranks[:V], sweeps, delta)
