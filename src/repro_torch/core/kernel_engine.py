"""DF/DF-P engine on the frontier-gated SpMV kernel (twin of
``repro.core.kernel_engine``).

Contributions come from the blocked, window-gated SpMV in f32 instead of
the f64 edge-list sum; frontier marking still uses the edge-list
``push_or``.  Two precision regimes, kept exactly as the reference has
them so that parity can be measured:

  * ``kernel_pagerank_loop`` — pure f32 with f32-appropriate tolerances;
    the rank buffer stays padded to NW·VB and each iteration computes
    ``active_window`` once for the kernel.
  * ``hybrid_pagerank`` — the serving ladder: f32 kernel iterations to
    ``tol_f32``, then the f64 loop (``core.pagerank``) seeded with the
    kernel phase's ``affected_ever`` set, down to the paper's τ.

``use_kernel`` ("auto", True or False) goes to ``gated_contrib``: "auto"
launches the kernel on CUDA tensors and runs its plain version on the
CPU; True insists on the kernel (raising on the CPU), False on the
plain version (raising on CUDA tensors).

Work accounting follows the kernel's granularity: per iteration,
``edges_processed`` adds the live-edge counts of active entries and
``vertices_processed`` adds VB per active window.

Sync policy: one boolean read (``delta > tol``) per iteration, as in the
f64 loop; the fused step adds one read of the dropped-insertion count.
Results carry the count in ``host_syncs``; each read is also recorded
with ``device.note_host_syncs``, beside those of the packed update.

``telemetry=True`` records one ``obs.frontier`` row an iteration (f32;
``active`` = active windows) and stacks it with that iteration's read:
no added sync, except when the f32 phase stops at ``max_iter``, whose
last sweep has no read after it untelemetered and then gets one for its
row.  ``_merged_telemetry`` puts the kernel rows first, then the
polish rows.  With the global tracer on, ``fused_update_loop`` and
``polish.f64`` (``kernel_loop.f32`` on the unfused ladder) are spans,
each closed by ``Tracer.sync``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import pagerank as pr
from repro_torch.core.pagerank import ALPHA, initial_affected
from repro_torch.device import note_host_syncs
from repro_torch.graph.structure import EdgeListGraph
from repro_torch.kernels.pagerank_spmv.ops import PackedGraph, gated_contrib
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.frontier import NUM_FIELDS, FrontierTelemetry, \
    read_row, telemetry_row

F32 = torch.float32


class KernelPRResult(NamedTuple):
    ranks: torch.Tensor               # f32[V]
    iterations: int
    delta: torch.Tensor               # f32[]
    affected_ever: torch.Tensor       # bool[V]
    edges_processed: torch.Tensor     # i64[] Σ live edges of active entries
    vertices_processed: torch.Tensor  # i64[] Σ VB per active window
    host_syncs: int = 0
    # f64[iters, 5] obs.frontier rows (NumPy) when asked, else None
    telemetry: Optional[np.ndarray] = None


class _Loop:
    """The f32 loop's constants and body, shared by the plain and fused
    entry points so that both run the identical iteration."""

    def __init__(self, graph, packed, *, alpha, tol, frontier_tol,
                 prune_tol, max_iter, closed_form, prune, expand,
                 telemetry=False, use_kernel="auto"):
        V = graph.num_vertices
        nw, vb = packed.num_windows, packed.vb
        self.graph, self.packed = graph, packed
        self.V, self.nw, self.vb, self.v_pad = V, nw, vb, nw * vb
        deg = graph.out_degree(include_self_loop=True)
        # 1/deg in f64, then rounded to f32, as the reference computes it
        self.inv_deg_pad = self._pad((1.0 / deg.to(torch.float64)).to(F32))
        # per-entry live-edge counts: constant across the loop
        self.entry_edges = (packed.valid > 0).sum(dim=1)
        dev = graph.device
        # fills, not uploads: no host sync
        self.c0 = torch.full((), (1.0 - alpha) / V, dtype=F32, device=dev)
        self.a32 = torch.full((), alpha, dtype=F32, device=dev)
        self.tol, self.max_iter = tol, max_iter
        self.frontier_tol, self.prune_tol = frontier_tol, prune_tol
        self.closed_form, self.prune, self.expand = closed_form, prune, expand
        self.use_kernel = use_kernel
        # telemetry: rows read so far, and the last sweep's row on the
        # device until its read
        self.rows = [] if telemetry else None
        self._row = None

    def _pad(self, x):
        return torch.cat([x, x.new_zeros(self.v_pad - x.shape[0])])

    def state0(self, init_ranks, init_affected):
        dev = self.graph.device
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return [self._pad(init_ranks.to(F32)), init_affected, init_affected,
                torch.full((), float("inf"), dtype=F32, device=dev), 0, zero,
                zero]

    def body(self, state):
        ranks_pad, affected, ever, _, it, edges, verts = state
        V, packed = self.V, self.packed
        aff_pad = torch.cat([affected, affected.new_zeros(self.v_pad - V)])
        active_window = aff_pad.reshape(self.nw, self.vb).any(dim=1)
        contrib = gated_contrib(packed, ranks_pad, self.inv_deg_pad,
                                active_window=active_window, pad_out=True,
                                use_kernel=self.use_kernel)
        c0, a32, inv = self.c0, self.a32, self.inv_deg_pad
        if self.closed_form:
            r_new_all = (c0 + a32 * contrib) / (1.0 - a32 * inv)
        else:
            r_new_all = c0 + a32 * (contrib + ranks_pad * inv)
        r_new = torch.where(aff_pad, r_new_all, ranks_pad)
        dr = (r_new - ranks_pad).abs()[:V]
        rel = dr / torch.maximum(torch.maximum(r_new[:V], ranks_pad[:V]),
                                 torch.full((), 1e-30, dtype=F32,
                                            device=dr.device))
        delta = torch.where(affected, dr, torch.zeros((), dtype=F32,
                                                      device=dr.device)).max()
        new_affected = affected
        if self.prune:
            new_affected = new_affected & ~(affected & (rel <= self.prune_tol))
        if self.expand:
            big = affected & (rel > self.frontier_tol)
            new_affected = new_affected | self.graph.push_or(big) | big
        edges = edges + torch.where(active_window[packed.window.long()],
                                    self.entry_edges,
                                    torch.zeros_like(self.entry_edges)).sum()
        n_win = active_window.sum(dtype=torch.int64)
        verts = verts + n_win * self.vb
        if self.rows is not None:
            self._row = telemetry_row(
                affected.sum(), delta, (new_affected & ~affected).sum(),
                (affected & ~new_affected).sum(), n_win, F32)
        return [r_new, new_affected, ever | new_affected, delta, it + 1,
                edges, verts]

    def _more(self, state) -> bool:
        """One host read: ``delta > tol``, with the last sweep's row when
        telemetry is on."""
        more = state[3] > self.tol
        if self._row is None:
            return bool(more)
        vals, more = read_row(self._row, more)
        self.rows.append(vals)
        self._row = None
        return more

    def run(self, state, syncs: int = 0,
            check_first: bool = False) -> KernelPRResult:
        """Iterate from ``state`` while ``delta > tol`` and under
        ``max_iter``: one host read after each iteration.  ``state0``'s
        delta is inf, so the first test needs no read unless the caller
        already ran a sweep (``check_first``)."""
        while state[4] < self.max_iter:
            if check_first:
                syncs += 1
                note_host_syncs()
                if not self._more(state):
                    break
            check_first = True
            state = self.body(state)
        tel = None
        if self.rows is not None:
            if self._row is not None:      # stopped at max_iter: read it
                syncs += 1
                note_host_syncs()
                self.rows.append(self._row.tolist())
                self._row = None
            tel = np.asarray(self.rows, np.float64).reshape(-1, NUM_FIELDS)
        ranks_pad, _, ever, delta, it, edges, verts = state
        return KernelPRResult(ranks_pad[:self.V], it, delta, ever, edges,
                              verts, syncs, tel)


def kernel_pagerank_loop(graph: EdgeListGraph, packed: PackedGraph,
                         init_ranks: torch.Tensor,
                         init_affected: torch.Tensor, *,
                         alpha: float = ALPHA, tol: float = 1e-7,
                         frontier_tol: float = 1e-5, prune_tol: float = 1e-5,
                         max_iter: int = 500, closed_form: bool = False,
                         prune: bool = False, expand: bool = True,
                         telemetry: bool = False,
                         use_kernel="auto") -> KernelPRResult:
    loop = _Loop(graph, packed, alpha=alpha, tol=tol,
                 frontier_tol=frontier_tol, prune_tol=prune_tol,
                 max_iter=max_iter, closed_form=closed_form, prune=prune,
                 expand=expand, telemetry=telemetry, use_kernel=use_kernel)
    return loop.run(loop.state0(init_ranks, init_affected))


def _fused_update_loop(graph_new: EdgeListGraph, packed: PackedGraph,
                       update, init_ranks: torch.Tensor,
                       init_affected: torch.Tensor, *,
                       alpha: float = ALPHA, tol: float = 1e-7,
                       frontier_tol: float = 1e-5, prune_tol: float = 1e-5,
                       max_iter: int = 500, closed_form: bool = False,
                       prune: bool = False, expand: bool = True,
                       telemetry: bool = False, use_kernel="auto"):
    """Packed micro-batch maintenance, then the f32 loop with its first
    sweep peeled (``delta`` starts at inf, so the peel cannot change the
    iteration sequence).  Returns ``(new_packed, KernelPRResult)``.

    A spill/overlay overflow raises the checked ``PackedSpillError`` right
    after maintenance, before any sweep.  Re-running after a repack is
    safe: the update's deletions are already absent and its insertions
    already live, so maintenance is a no-op and only the solve repeats.
    """
    from repro_torch.kernels.pagerank_spmv.update import (
        SPILL_ERROR, PackedSpillError, _apply_batch_packed)
    new_packed, dropped = _apply_batch_packed(packed, update)
    note_host_syncs()
    n = int(dropped)
    if n:
        raise PackedSpillError(SPILL_ERROR.format(n=n))
    loop = _Loop(graph_new, new_packed, alpha=alpha, tol=tol,
                 frontier_tol=frontier_tol, prune_tol=prune_tol,
                 max_iter=max_iter, closed_form=closed_form, prune=prune,
                 expand=expand, telemetry=telemetry, use_kernel=use_kernel)
    state = loop.state0(init_ranks, init_affected)
    if max_iter > 0:
        state = loop.body(state)
    return new_packed, loop.run(state, syncs=1, check_first=True)


def _merged_telemetry(k: KernelPRResult,
                      p: Optional[pr.PageRankResult]) -> np.ndarray:
    """f64 [iters, k] rows of the hybrid ladder, kernel phase first then
    polish (both already on the host)."""
    return FrontierTelemetry.concat(
        FrontierTelemetry(k.telemetry),
        None if p is None else FrontierTelemetry(p.telemetry)).data


def _ladder(graph, k: KernelPRResult, *, alpha, tol, frontier_tol,
            prune_tol, max_iter, closed_form, prune, expand,
            polish, telemetry=False) -> pr.PageRankResult:
    """f64 result of the ladder from its f32 phase ``k``."""
    if not polish:
        return pr.PageRankResult(
            k.ranks.to(torch.float64), k.iterations,
            k.delta.to(torch.float64), k.affected_ever, k.edges_processed,
            k.vertices_processed, k.host_syncs,
            _merged_telemetry(k, None) if telemetry else None)
    tr = obs_trace.get_tracer()
    with tr.span("polish.f64", program="f64_polish"):
        p = pr._pagerank_loop(graph, k.ranks.to(torch.float64),
                              k.affected_ever, alpha=alpha, tol=tol,
                              frontier_tol=frontier_tol,
                              prune_tol=prune_tol, max_iter=max_iter,
                              closed_form=closed_form, prune=prune,
                              expand=expand, telemetry=telemetry)
        tr.sync(p.ranks)
    return pr.PageRankResult(
        p.ranks, k.iterations + p.iterations, p.delta,
        k.affected_ever | p.affected_ever,
        k.edges_processed + p.edges_processed,
        k.vertices_processed + p.vertices_processed,
        k.host_syncs + p.host_syncs,
        _merged_telemetry(k, p) if telemetry else None)


def fused_hybrid_pagerank(graph_new: EdgeListGraph, packed: PackedGraph,
                          update, init_ranks: torch.Tensor,
                          init_affected: torch.Tensor, *,
                          alpha: float = ALPHA, tol: float = pr.TOL,
                          tol_f32: float = 1e-7,
                          frontier_tol: float = pr.FRONTIER_TOL,
                          prune_tol: float = pr.PRUNE_TOL,
                          kernel_frontier_tol: float = 1e-5,
                          kernel_prune_tol: float = 1e-5,
                          max_iter: int = pr.MAX_ITER,
                          closed_form: bool = False, prune: bool = False,
                          expand: bool = True, polish: bool = True,
                          telemetry: bool = False, use_kernel="auto"):
    """Serving step: ``(new_packed, PageRankResult)`` — packed maintenance
    plus the whole f32 phase, then the f64 polish when ``polish=True``.

    Spill/overlay exhaustion raises the same checked ``PackedSpillError`` as
    ``apply_batch_packed``; the caller repacks at the pinned shapes and
    re-invokes with the SAME update.

    ``telemetry=True`` records per-iteration ``obs.frontier`` rows in both
    phases (``result.telemetry``: f64 [iters, k], kernel rows then polish
    rows); the tracer, when enabled, gets one span per phase.
    """
    tr = obs_trace.get_tracer()
    with tr.span("fused_update_loop", program="update+f32_loop"):
        new_packed, k = _fused_update_loop(
            graph_new, packed, update, init_ranks, init_affected,
            alpha=alpha, tol=tol_f32, frontier_tol=kernel_frontier_tol,
            prune_tol=kernel_prune_tol, max_iter=max_iter,
            closed_form=closed_form, prune=prune, expand=expand,
            telemetry=telemetry, use_kernel=use_kernel)
        tr.sync(k.ranks)
    return new_packed, _ladder(
        graph_new, k, alpha=alpha, tol=tol, frontier_tol=frontier_tol,
        prune_tol=prune_tol, max_iter=max_iter, closed_form=closed_form,
        prune=prune, expand=expand, polish=polish, telemetry=telemetry)


def hybrid_pagerank(graph: EdgeListGraph, packed: PackedGraph,
                    init_ranks: torch.Tensor, init_affected: torch.Tensor, *,
                    alpha: float = ALPHA, tol: float = pr.TOL,
                    tol_f32: float = 1e-7,
                    frontier_tol: float = pr.FRONTIER_TOL,
                    prune_tol: float = pr.PRUNE_TOL,
                    kernel_frontier_tol: float = 1e-5,
                    kernel_prune_tol: float = 1e-5,
                    max_iter: int = pr.MAX_ITER, closed_form: bool = False,
                    prune: bool = False, expand: bool = True,
                    polish: bool = True,
                    telemetry: bool = False,
                    use_kernel="auto") -> pr.PageRankResult:
    """Precision ladder: f32 kernel iterations to ``tol_f32``, then an
    optional f64 polish seeded from the kernel phase's affected_ever set
    down to ``tol`` — same fixed point and result type as the f64 loop."""
    tr = obs_trace.get_tracer()
    with tr.span("kernel_loop.f32", program="f32_loop"):
        k = kernel_pagerank_loop(graph, packed, init_ranks, init_affected,
                                 alpha=alpha, tol=tol_f32,
                                 frontier_tol=kernel_frontier_tol,
                                 prune_tol=kernel_prune_tol,
                                 max_iter=max_iter, closed_form=closed_form,
                                 prune=prune, expand=expand,
                                 telemetry=telemetry, use_kernel=use_kernel)
        tr.sync(k.ranks)
    return _ladder(graph, k, alpha=alpha, tol=tol, frontier_tol=frontier_tol,
                   prune_tol=prune_tol, max_iter=max_iter,
                   closed_form=closed_form, prune=prune, expand=expand,
                   polish=polish, telemetry=telemetry)


def df_pagerank_kernel(graph_prev: EdgeListGraph, graph_new: EdgeListGraph,
                       packed_new: PackedGraph, touched: torch.Tensor,
                       prev_ranks: torch.Tensor, *, prune: bool = False,
                       **kw) -> KernelPRResult:
    aff = initial_affected(graph_prev, graph_new, touched)
    return kernel_pagerank_loop(graph_new, packed_new, prev_ranks, aff,
                                prune=prune, closed_form=prune, **kw)
