"""DF/DF-P PageRank over a device mesh, one controller driving every shard
(twin of ``repro.dist.pagerank_dist``).

Two engines, as in the reference:

  * the **xla engine** (``build_distributed_step`` / ``DistributedEngine``):
    f64 pull sums over model-owned vertex ranges and data-striped edges
    (``graph/partition.py``);
  * the **kernel engine** (``sharded_kernel_pagerank`` /
    ``ShardedKernelEngine``): the ``frontier_spmv`` kernel over a
    window-range-sharded ``PackedGraph`` (``kernels/pagerank_spmv/
    shard.py``), launched once a shard an iteration, f32 iterations, then
    the f32→f64 polish of the single-device ladder
    (``core/kernel_engine.py``) over the union of the shards'
    ``affected_ever``.

Layout: the ``model`` axis owns contiguous dst ranges; the data axes
stripe the edges within each range.  Shard *m*'s vertex state lives on the
mesh's device for (data 0, model m), stripe (p, m)'s edges on the device
at (p, m); the reassembled vectors the loops test and the f64 polish live
on the graph's device.  Where the reference runs an all-gather or a psum
inside ``shard_map``, the controller moves each shard's part to its
reader and adds in shard order (``dist/collectives.py``), so results are
bitwise run to run.  The loops are Python loops with one host read an
iteration (``delta > tol``), the port's sync policy; every read is
recorded with ``device.note_host_syncs``.

One xla iteration: the packed ``[V/M, 2]`` gather of (rank/degree, last
sweep's above-tau_f flag); each stripe's f64 pull sum (``pull_values``
over the stripe's dst order, the port's ``pull_contrib`` kernel) and its
``push_or`` marks (``segment_or``); the stripes' sums added in data
order, their marks OR-ed over the int8 wire (``bool_or_psum``); the DF /
DF-P update.  Expansion marks are consumed one sweep later, which only
reassociates the affected-set union.

The kernel engine's two exchanges: ``halo`` (the default) keeps ranks on
their shard and moves, each iteration, only the halo table (every shard's
boundary-in sources, from their owners: ``wire="packed"`` rides the flags
in f32 lanes, ``"quantized"`` sends them over the int8 wire); ``psum``
keeps the rank vector replicated and reassembles the full contribution
vector each iteration (O(V) wire).  ``halo_comm_bytes`` accounts what the
halo moves.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import pagerank as pr
from repro_torch.core.pagerank import (ALPHA, FRONTIER_TOL, MAX_ITER,
                                       PRUNE_TOL, TOL)
from repro_torch.device import note_host_syncs
from repro_torch.dist.collectives import bool_or_psum, pmax, psum
from repro_torch.dist.sharding import ShardSpec
from repro_torch.graph.partition import (edges_per_device, partition_graph,
                                         vertices_per_shard)
from repro_torch.kernels.pagerank_spmv.pagerank_spmv import \
    frontier_spmv_padded
from repro_torch.kernels.pull_contrib.pull_contrib import (pull_order,
                                                            pull_values)
from repro_torch.kernels.segment_ops.plan import cached
from repro_torch.kernels.slot_count.slot_count import segment_or
from repro_torch.launch.mesh import Mesh, data_axes
from repro_torch.obs import trace as obs_trace

F32, F64 = torch.float32, torch.float64

__all__ = ["build_distributed_step", "DistributedEngine",
           "distributed_in_shardings", "distributed_input_specs",
           "sharded_hybrid_pagerank", "sharded_kernel_pagerank",
           "ShardedKernelEngine", "halo_comm_bytes"]


def _mesh_dims(mesh):
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.launch.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    if "model" not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no 'model' axis")
    dax = data_axes(mesh)
    sizes = mesh.shape
    m = sizes["model"]
    p = int(math.prod(sizes[a] for a in dax) or 1)
    return m, p, dax


def _edge_spec(dax) -> tuple:
    return ("model", dax[0] if len(dax) == 1 else dax, None)


def distributed_in_shardings(mesh):
    """``ShardSpec``s of the step's 6 arguments (src, dst_local, valid,
    ranks, inv_out_deg, affected): the edge tensors [M, P, E_dev] split
    over ``model`` and the data axes, the vertex vectors over
    ``model``."""
    es = ShardSpec(mesh, _edge_spec(data_axes(mesh)))
    vs = ShardSpec(mesh, ("model",))
    return (es, es, es, vs, vs, vs)


def distributed_input_specs(mesh, n_vertices: int, edge_capacity: int,
                            dtype=F32):
    """The step's 6 arguments as ``meta`` tensors (shapes and dtypes, no
    allocation): ``partition_graph``'s balanced-stripe shapes on this
    mesh, for the dry-run."""
    m, p, _ = _mesh_dims(mesh)
    v_pad = vertices_per_shard(n_vertices, m) * m
    e_dev = edges_per_device(edge_capacity, m, p)

    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    return (meta((m, p, e_dev), torch.int32),
            meta((m, p, e_dev), torch.int32),
            meta((m, p, e_dev), torch.bool),
            meta((v_pad,), dtype), meta((v_pad,), dtype),
            meta((v_pad,), torch.bool))


def _stripe_devices(mesh) -> np.ndarray:
    """[P, M] devices: stripe (p, m)'s, the data axes flattened."""
    m = mesh.shape["model"]
    k = mesh.axis_names.index("model")
    return np.moveaxis(mesh.devices, k, -1).reshape(-1, m)


def _fill(value, dtype, dev):
    """A 0-d tensor made on the device (a fill, not an upload)."""
    return torch.full((), value, dtype=dtype, device=dev)


# ---------------------------------------------------------------------------
# the xla engine: f64 pull sums over a dst-range x edge-stripe partition
# ---------------------------------------------------------------------------

class _Stripe(NamedTuple):
    order: object               # PullOrder of the stripe's slots (local dst)
    in_deg: torch.Tensor        # int64[v_per] live in-edges of the stripe


def build_distributed_step(mesh, n_vertices: int, *,
                           alpha: float = ALPHA, tol: float = TOL,
                           frontier_tol: float = FRONTIER_TOL,
                           prune_tol: float = PRUNE_TOL,
                           max_iter: int = MAX_ITER,
                           prune: bool = False,
                           closed_form: Optional[bool] = None,
                           int8_frontier: bool = True,
                           full_result: bool = False):
    """DF (default) / DF-P (``prune=True``) iteration over ``mesh``.

    Returns ``fn(src, dst_local, valid, ranks, inv_out_deg, affected)``
    over ``partition_graph``'s layout: edge tensors [M, P, E_dev], vertex
    tensors [v_per·M] (pad slots unaffected, inverse degree 0).  ``fn`` →
    (ranks, iterations, delta), plus (affected_ever, edges_processed,
    vertices_processed) when ``full_result``.  The fixed point is
    ``core.pagerank``'s; pruning, expansion and the DF-P closed form apply
    each Jacobi iteration as Algorithm 1 lines 9-26.
    """
    if closed_form is None:
        closed_form = prune
    M, P, _ = _mesh_dims(mesh)
    sdev = _stripe_devices(mesh)
    vdev = [sdev[0, m] for m in range(M)]
    c0_val = (1.0 - alpha) / n_vertices

    def or_data(flags):
        if len(flags) == 1:
            return flags[0]
        if int8_frontier:
            return bool_or_psum(flags)
        return psum([f.to(torch.int32) for f in flags]) > 0

    def step(src, dst, valid, ranks, inv_deg, affected):
        cdev = ranks.device
        v_per = ranks.shape[0] // M
        stripes = [[None] * M for _ in range(P)]
        for p in range(P):
            for m in range(M):
                d = sdev[p, m]
                s, t, ok = (x[m, p].to(d) for x in (src, dst, valid))
                order = pull_order(s, t, ok, v_per)
                stripes[p][m] = _Stripe(order, (order.ptr[1:]
                                                - order.ptr[:-1]).long())
        in_deg = [psum([stripes[p][m].in_deg for p in range(P)])
                  for m in range(M)]
        split = lambda x: [x[m * v_per:(m + 1) * v_per].to(vdev[m])
                           for m in range(M)]
        r = split(ranks.to(F64))
        inv = split(inv_deg.to(F64))
        base = split(affected)
        big = [torch.zeros_like(b) for b in base]
        ever = list(base)
        c0 = _fill(c0_val, F64, cdev)
        tiny = _fill(torch.finfo(F64).tiny, F64, cdev)
        zero = _fill(0.0, F64, cdev)
        edges = verts = torch.zeros((), dtype=torch.int64, device=cdev)
        delta = _fill(float("inf"), F64, cdev)
        it, syncs = 0, 0

        def push_marks(big_full):
            """Alg.1 line 22 marks a range: each stripe's segment OR over
            the gathered above-tau_f set, OR-ed over the data axes."""
            return [or_data([segment_or(stripes[p][m].order.ptr,
                                        stripes[p][m].order.src,
                                        stripes[p][m].order.dst,
                                        big_full.to(sdev[p, m]))
                             .to(vdev[m]) for p in range(P)])
                    for m in range(M)]

        while it < max_iter:
            if it > 0:
                syncs += 1
                note_host_syncs()
                if not bool(delta > tol):
                    break
            # one packed [V/M, 2] gather a sweep: R/d with last sweep's
            # above-tau_f flag
            full = torch.cat([torch.stack([r[m] * inv[m],
                                           big[m].to(F64)], dim=1).to(cdev)
                              for m in range(M)])
            w_full, big_full = full[:, 0].contiguous(), full[:, 1] > 0
            marks = push_marks(big_full)
            aff = [base[m] | big[m] | marks[m] for m in range(M)]
            new = []
            for m in range(M):
                contrib = psum([pull_values(stripes[p][m].order,
                                            w_full.to(sdev[p, m]))
                                .to(vdev[m]) for p in range(P)])
                if closed_form:                   # DF-P (paper Eq. 2)
                    r_all = (c0.to(vdev[m]) + alpha * contrib) \
                        / (1.0 - alpha * inv[m])
                else:                             # DF: self-loop as a term
                    r_all = c0.to(vdev[m]) + alpha * (contrib + r[m] * inv[m])
                r_new = torch.where(aff[m], r_all, r[m])
                dr = (r_new - r[m]).abs()
                rel = dr / torch.maximum(torch.maximum(r_new, r[m]),
                                         tiny.to(vdev[m]))
                d_m = torch.where(aff[m], dr, zero.to(vdev[m])).max()
                b = aff[m]
                if prune:                         # Alg.1 line 19
                    b = b & ~(aff[m] & (rel <= prune_tol))
                new.append((r_new, b, aff[m] & (rel > frontier_tol), d_m))
            delta = pmax([x[3].to(cdev) for x in new])
            edges = edges + psum([torch.where(aff[m], in_deg[m],
                                              torch.zeros_like(in_deg[m]))
                                  .sum().to(cdev) for m in range(M)])
            verts = verts + psum([aff[m].sum(dtype=torch.int64).to(cdev)
                                  for m in range(M)])
            r = [x[0] for x in new]
            base = [x[1] for x in new]
            big = [x[2] for x in new]
            ever = [ever[m] | aff[m] for m in range(M)]
            it += 1
        cat = lambda xs: torch.cat([x.to(cdev) for x in xs])
        res = (cat(r).to(ranks.dtype), it, delta)
        if full_result:
            # fold in the final sweep's unexpanded marks, so that
            # affected_ever matches the single-device engine
            last = push_marks(cat(big))
            res += (cat([ever[m] | last[m] for m in range(M)]), edges,
                    verts)
        step.host_syncs = syncs
        return res

    step.host_syncs = 0
    return step


class DistributedEngine:
    """Replays a dynamic-graph stream on a mesh: the host partition of
    each batch's graph (``partition_graph``), uploaded once, then
    ``build_distributed_step``'s loop.  The per-device edge capacity is
    pre-sized from the graph's edge capacity and grows (sticky) on skew.
    """

    def __init__(self, mesh, n_vertices: int, edge_capacity: int, **opts):
        self.mesh = mesh
        self.m, self.p, _ = _mesh_dims(mesh)
        self.n_vertices = n_vertices
        self.v_per = vertices_per_shard(n_vertices, self.m)
        self.v_pad = self.v_per * self.m
        e_dev = -(-edge_capacity // max(1, self.m * self.p))
        self.e_dev = max(128, -(-e_dev // 128) * 128)
        self._fn = build_distributed_step(mesh, n_vertices,
                                          full_result=True, **opts)

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, x.new_zeros(self.v_pad - x.shape[0])])

    def run(self, graph, ranks, affected):
        """graph: EdgeListGraph; ranks f64[V]; affected bool[V] →
        (ranks f64[V], iterations, delta, affected_ever bool[V],
        edges_processed, vertices_processed, the loop's host reads)."""
        part = partition_graph(graph, self.m, self.p,
                               min_edges_per_device=self.e_dev)
        self.e_dev = part.src.shape[2]            # sticky growth on skew
        dev = graph.device
        note_host_syncs(3)                        # three pageable uploads
        src, dst, valid = (torch.from_numpy(a).to(dev)
                           for a in (part.src, part.dst_local, part.valid))
        inv = 1.0 / graph.out_degree(include_self_loop=True).to(F64)
        r, it, delta, ever, edges, verts = self._fn(
            src, dst, valid, self._pad(ranks.to(F64)), self._pad(inv),
            self._pad(affected))
        V = self.n_vertices
        return (r[:V], it, delta, ever[:V], edges, verts,
                self._fn.host_syncs)


# ---------------------------------------------------------------------------
# the kernel engine on the mesh: window-range-sharded frontier-gated SpMV
# ---------------------------------------------------------------------------

def _lane_order(packed, vps: int):
    """The shard's packed lanes sorted by local dst (``pull_order``), built
    once a packed structure and cached with it: the halo loop's
    expansion marks are ``segment_or`` over it."""
    def build():
        src = packed.src.reshape(-1)
        dst = (packed.window.long()[:, None] * packed.vb
               + packed.dst_rel.long()).reshape(-1).to(torch.int32)
        return pull_order(src, dst, packed.valid.reshape(-1) > 0, vps)
    return cached(packed.src, ("lane_order", vps), build)


def _statics(sharded, spec, graph, init_ranks, alpha):
    """Constants both f32 loops share: (inv_pad f32[v_pad], r_pad
    f32[v_pad], per-shard live-lane counts of each entry, c0, alpha)."""
    V, v_pad = spec.num_vertices, spec.padded_vertices
    deg = graph.out_degree(include_self_loop=True)
    pad = lambda x: torch.cat([x, x.new_zeros(v_pad - V)])
    inv_pad = pad((1.0 / deg.to(F64)).to(F32))
    r_pad = pad(init_ranks.to(F32))
    entry_edges = [(p.valid > 0).sum(dim=1) for p in sharded.shards]
    dev = graph.device
    return (inv_pad, r_pad, entry_edges, _fill((1.0 - alpha) / V, F32, dev),
            _fill(alpha, F32, dev))


def _psum_loop(sharded, spec, graph, init_ranks, init_affected, *, alpha,
               tol, frontier_tol, prune_tol, max_iter, closed_form, prune,
               expand, use_kernel):
    """The replicated-rank recipe: rank state and masks stay whole on the
    graph's device; each iteration every shard runs its gated SpMV
    (``frontier_spmv``, one launch a shard) and the full contribution
    vector is reassembled from the shards' disjoint slices."""
    S, wps, vb = spec.num_shards, spec.windows_per_shard, spec.vb
    vps, v_pad, V = spec.vertices_per_shard, spec.padded_vertices, \
        spec.num_vertices
    dev = graph.device
    devs = sharded.devices
    inv_pad, r_pad, entry_edges, c0, a32 = _statics(
        sharded, spec, graph, init_ranks, alpha)
    tiny = _fill(1e-30, F32, dev)
    zero = _fill(0.0, F32, dev)
    aff, ever = init_affected, init_affected
    delta = _fill(float("inf"), F32, dev)
    edges = verts = torch.zeros((), dtype=torch.int64, device=dev)
    it = syncs = 0
    while it < max_iter:
        if it > 0:
            syncs += 1
            note_host_syncs()
            if not bool(delta > tol):
                break
        aff_pad = torch.cat([aff, aff.new_zeros(v_pad - V)])
        active = aff_pad.reshape(S * wps, vb).any(dim=1)
        rsc = r_pad * inv_pad
        parts, e_s, v_s = [], [], []
        for s, p in enumerate(sharded.shards):
            a_l = active[s * wps:(s + 1) * wps].to(devs[s])
            parts.append(frontier_spmv_padded(p, rsc.to(devs[s]), a_l,
                                              use_kernel=use_kernel))
            e_s.append(torch.where(a_l[p.window.long()], entry_edges[s],
                                   torch.zeros_like(entry_edges[s])).sum())
            v_s.append(a_l.sum(dtype=torch.int64) * vb)
        contrib = torch.cat([c.to(dev) for c in parts])
        if closed_form:
            r_new_all = (c0 + a32 * contrib) / (1.0 - a32 * inv_pad)
        else:
            r_new_all = c0 + a32 * (contrib + r_pad * inv_pad)
        r_new = torch.where(aff_pad, r_new_all, r_pad)
        dr = (r_new - r_pad).abs()[:V]
        rel = dr / torch.maximum(torch.maximum(r_new[:V], r_pad[:V]), tiny)
        delta = torch.where(aff, dr, zero).max()
        new_aff = aff
        if prune:
            new_aff = new_aff & ~(aff & (rel <= prune_tol))
        if expand:
            big = aff & (rel > frontier_tol)
            new_aff = new_aff | graph.push_or(big) | big
        edges = edges + psum(e_s).to(dev)
        verts = verts + psum(v_s).to(dev)
        r_pad, aff, ever = r_new, new_aff, ever | new_aff
        it += 1
    return r_pad[:V], it, delta, ever, edges, verts, syncs


def _halo_loop(sharded, spec, halo, graph, init_ranks, init_affected, *,
               alpha, tol, frontier_tol, prune_tol, max_iter, closed_form,
               prune, expand, use_kernel, wire):
    """Boundary-only recipe: ranks stay on their shard and each iteration
    moves only the halo table.

      1. every shard's halo slots are filled by their owners (each slot
         has one owner; the others add zeros): the (rank/degree,
         above-tau_f flag) pair, the flags over the int8 wire with
         ``wire="quantized"`` or riding f32 lanes with ``"packed"``;
      2. each shard writes its row into a full-width local buffer (its own
         range + its halo; every src of its lanes is one of the two),
         runs the gated SpMV over its own windows and updates its ranks;
      3. expansion marks come from the shard's own lanes (``segment_or``
         over their dst order), one sweep late: the flag lane carries the
         previous sweep's mask, and the final sweep's marks are folded in
         after the loop with one more exchange.
    """
    S, wps, vb = spec.num_shards, spec.windows_per_shard, spec.vb
    vps, v_pad, V = spec.vertices_per_shard, spec.padded_vertices, \
        spec.num_vertices
    dev = graph.device
    devs = sharded.devices
    inv_pad, r_pad, entry_edges, c0, a32 = _statics(
        sharded, spec, graph, init_ranks, alpha)
    aff_pad = torch.cat([init_affected,
                         init_affected.new_zeros(v_pad - V)])
    loc = lambda x, s: x[s * vps:(s + 1) * vps].to(devs[s])
    r = [loc(r_pad, s) for s in range(S)]
    inv = [loc(inv_pad, s) for s in range(S)]
    base = [loc(aff_pad, s) for s in range(S)]
    big = [torch.zeros_like(b) for b in base]
    ever = list(base)
    ids = [halo.ids[s].to(devs[s]) for s in range(S)]
    live_ids = [torch.where(i < v_pad, i.long(),
                            torch.full_like(i.long(), v_pad)) for i in ids]
    orders = ([_lane_order(p, vps) for p in sharded.shards] if expand
              else None)
    consts = [(c0.to(d), a32.to(d), _fill(1e-30, F32, d), _fill(0.0, F32, d))
              for d in devs]

    def exchange(rsc_loc, big_loc):
        """Every shard's (rsc_full, big_full) buffers of v_pad slots."""
        out = []
        for s in range(S):
            my = ids[s]
            vals, flags = [], []
            for o in range(S):              # owners, in shard order
                mine = my.to(devs[o])
                own = (mine >= o * vps) & (mine < (o + 1) * vps)
                lid = torch.clamp(mine.long() - o * vps, 0, vps - 1)
                vals.append(torch.where(own, rsc_loc[o][lid],
                                        consts[o][3]).to(devs[s]))
                flags.append((own & big_loc[o][lid]).to(devs[s]))
            if wire == "quantized":
                v, f = psum(vals), bool_or_psum(flags)
            else:
                both = psum([torch.stack([v_, f_.to(F32)], dim=1)
                             for v_, f_ in zip(vals, flags)])
                v, f = both[:, 0], both[:, 1] > 0
            rsc_full = torch.zeros(v_pad + 1, dtype=F32, device=devs[s])
            rsc_full[s * vps:(s + 1) * vps] = rsc_loc[s]
            rsc_full.index_copy_(0, live_ids[s], v)
            big_full = torch.zeros(v_pad + 1, dtype=torch.bool,
                                   device=devs[s])
            big_full[s * vps:(s + 1) * vps] = big_loc[s]
            big_full.index_copy_(0, live_ids[s], f)
            out.append((rsc_full[:v_pad], big_full[:v_pad]))
        return out

    def marks_from(s, big_full):
        o = orders[s]
        return segment_or(o.ptr, o.src, o.dst, big_full)

    delta = _fill(float("inf"), F32, dev)
    edges = verts = torch.zeros((), dtype=torch.int64, device=dev)
    it = syncs = 0
    while it < max_iter:
        if it > 0:
            syncs += 1
            note_host_syncs()
            if not bool(delta > tol):
                break
        bufs = exchange([r[s] * inv[s] for s in range(S)], big)
        new, e_s, v_s = [], [], []
        for s, p in enumerate(sharded.shards):
            c0_, a_, tiny, zero = consts[s]
            aff = base[s] | big[s]
            if expand:
                aff = aff | marks_from(s, bufs[s][1])
            active_l = aff.reshape(wps, vb).any(dim=1)
            contrib = frontier_spmv_padded(p, bufs[s][0], active_l,
                                           use_kernel=use_kernel)
            if closed_form:
                r_all = (c0_ + a_ * contrib) / (1.0 - a_ * inv[s])
            else:
                r_all = c0_ + a_ * (contrib + r[s] * inv[s])
            r_new = torch.where(aff, r_all, r[s])
            dr = (r_new - r[s]).abs()
            rel = dr / torch.maximum(torch.maximum(r_new, r[s]), tiny)
            nb = aff
            if prune:
                nb = nb & ~(aff & (rel <= prune_tol))
            ng = (aff & (rel > frontier_tol)) if expand \
                else torch.zeros_like(aff)
            new.append((r_new, nb, ng, ever[s] | aff,
                        torch.where(aff, dr, zero).max()))
            e_s.append(torch.where(active_l[p.window.long()],
                                   entry_edges[s],
                                   torch.zeros_like(entry_edges[s])).sum())
            v_s.append(active_l.sum(dtype=torch.int64) * vb)
        r, base, big, ever = ([x[i] for x in new] for i in range(4))
        delta = pmax([x[4] for x in new]).to(dev)
        edges = edges + psum(e_s).to(dev)
        verts = verts + psum(v_s).to(dev)
        it += 1
    if expand:
        # fold in the final sweep's unconsumed marks (one more exchange)
        bufs = exchange([r[s] * inv[s] for s in range(S)], big)
        ever = [ever[s] | marks_from(s, bufs[s][1]) for s in range(S)]
    cat = lambda xs: torch.cat([x.to(dev) for x in xs])[:V]
    return cat(r), it, delta, cat(ever), edges, verts, syncs


# nominal link rate used ONLY to give the modeled ``halo.exchange`` trace
# span a duration; never for decisions
_LINK_BW_BYTES_PER_S = 25e9


def halo_comm_bytes(halo, iterations: int, *, wire: str = "packed",
                    expand: bool = True) -> int:
    """Wire bytes of one solve's halo exchanges (a device's): each
    iteration moves the [S, H] rank lanes (f32) and the flag lanes (f32
    packed, or int16 over the quantized wire); the final fold-in is one
    more exchange."""
    from repro_torch.kernels.pagerank_spmv.shard import halo_slots
    slots = halo_slots(halo)
    per_iter = slots * (4 + (2 if wire == "quantized" else 4))
    return (int(iterations) + (1 if expand else 0)) * per_iter


def sharded_hybrid_pagerank(mesh, sharded, spec, graph, init_ranks,
                            init_affected, *, alpha: float = ALPHA,
                            tol: float = TOL, tol_f32: float = 1e-7,
                            frontier_tol: float = FRONTIER_TOL,
                            prune_tol: float = PRUNE_TOL,
                            kernel_frontier_tol: float = 1e-5,
                            kernel_prune_tol: float = 1e-5,
                            max_iter: int = MAX_ITER,
                            closed_form: bool = False, prune: bool = False,
                            expand: bool = True, polish: bool = True,
                            use_kernel="auto", halo=None,
                            wire: str = "packed",
                            comm_info: Optional[dict] = None,
                            telemetry: bool = False) -> pr.PageRankResult:
    """The sharded precision ladder: f32 kernel iterations on the mesh to
    ``tol_f32``, then the f64 polish on the graph's device seeded with the
    union of the shards' ``affected_ever`` — the fixed point and result of
    ``core.kernel_engine.hybrid_pagerank`` (L∞ ≤ 1e-6).

    ``halo`` (a ``shard.HaloSpec``) selects the boundary-only exchange,
    else the replicated-rank one.  ``comm_info`` (a dict, filled in)
    receives ``f32_iterations``, ``halo_slots`` and ``comm_bytes``.
    ``telemetry=True`` records the polish's frontier rows (the f32 phase
    is summarized in ``comm_info``); with the tracer on, the f32 loop is
    a span and the exchange a modeled span from the wire accounting.
    """
    tr = obs_trace.get_tracer()
    v_pad = spec.padded_vertices
    loop_kw = dict(alpha=alpha, tol=tol_f32,
                   frontier_tol=kernel_frontier_tol,
                   prune_tol=kernel_prune_tol, max_iter=max_iter,
                   closed_form=closed_form, prune=prune, expand=expand,
                   use_kernel=use_kernel)
    s0 = tr.now()
    if halo is not None:
        k_ranks, it, delta, ever, edges, verts, syncs = _halo_loop(
            sharded, spec, halo, graph, init_ranks, init_affected,
            wire=wire, **loop_kw)
        cb = halo_comm_bytes(halo, it, wire=wire, expand=expand)
        slots = int(halo.ids.shape[0] * halo.ids.shape[1])
    else:
        k_ranks, it, delta, ever, edges, verts, syncs = _psum_loop(
            sharded, spec, graph, init_ranks, init_affected, **loop_kw)
        # one full-rank [v_pad] f32 psum an iteration on every device
        cb, slots = it * v_pad * 4, 0
    if comm_info is not None:
        comm_info.update(f32_iterations=it, halo_slots=slots,
                         comm_bytes=cb)
    if tr.enabled:
        tr.sync(k_ranks)
        tr.record("sharded_f32_loop", s0, tr.now() - s0,
                  exchange="halo" if halo is not None else "psum",
                  iterations=it)
        tr.record("halo.exchange", s0, cb / _LINK_BW_BYTES_PER_S,
                  comm_bytes=int(cb), modeled=True,
                  wire=wire if halo is not None else "psum")
    if not polish:
        return pr.PageRankResult(k_ranks.to(F64), it, delta.to(F64), ever,
                                 edges, verts, syncs)
    with tr.span("polish.f64", program="f64_polish"):
        p = pr._pagerank_loop(graph, k_ranks.to(F64), ever, alpha=alpha,
                              tol=tol, frontier_tol=frontier_tol,
                              prune_tol=prune_tol, max_iter=max_iter,
                              closed_form=closed_form, prune=prune,
                              expand=expand, telemetry=telemetry)
        tr.sync(p.ranks)
    return pr.PageRankResult(p.ranks, it + p.iterations, p.delta,
                             ever | p.affected_ever,
                             edges + p.edges_processed,
                             verts + p.vertices_processed,
                             syncs + p.host_syncs,
                             p.telemetry if telemetry else None)


def sharded_kernel_pagerank(graph, init_ranks, init_affected, mesh, *,
                            sharded=None, spec=None, pack_kw=None,
                            **kw) -> pr.PageRankResult:
    """One-shot ``engine="kernel"`` on a mesh: pack (unless the caller
    keeps the sharded structure, as ``ShardedKernelEngine`` does) and run
    the sharded ladder."""
    from repro_torch.kernels.pagerank_spmv.shard import build_halo, \
        pack_shards
    M, _, _ = _mesh_dims(mesh)
    if sharded is None:
        sharded, spec = pack_shards(graph, M,
                                    devices=mesh.axis_devices("model"),
                                    **(pack_kw or {}))
    if kw.pop("exchange", "halo") == "halo" and "halo" not in kw:
        kw["halo"] = build_halo(sharded, spec)
    return sharded_hybrid_pagerank(mesh, sharded, spec, graph, init_ranks,
                                   init_affected, **kw)


class ShardedKernelEngine:
    """Streaming owner of the sharded kernel path: one sharded pack a
    bootstrap, each batch's deltas routed to their shards and applied
    there, the sharded ladder a solve.

    Every pack static is pinned at construction (entry capacity, the
    per-window entry bound, overlay size), so a ``repack`` keeps the
    ``ShardSpec``.  ``delta_budget`` bounds each shard's routed rows of a
    batch (None: the whole batch); overflowing it, a window's spill
    lanes, the overlay or the halo raises ``ShardCapacityError`` naming
    the shards, which the owner answers with ``repack``.

    ``exchange="halo"`` (the default) keeps ranks on their shard and
    exchanges only the boundary each f32 iteration: the table is built at
    bootstrap, extended as routed insertions land (capacity-checked) and
    rebuilt exactly by a repack.  ``exchange="psum"`` keeps ranks
    replicated.  After each solve ``last_comm_info`` /
    ``last_comm_bytes`` hold the wire accounting.
    """

    def __init__(self, mesh, graph, *, pack_kw=None, delta_budget=None,
                 use_kernel="auto", exchange: str = "halo",
                 wire: str = "packed", halo_capacity=None, **loop_kw):
        from repro_torch.kernels.pagerank_spmv.shard import build_halo, \
            pack_shards
        M, _, _ = _mesh_dims(mesh)
        if exchange not in ("halo", "psum"):
            raise ValueError(f"exchange must be 'halo' or 'psum', "
                             f"got {exchange!r}")
        if wire not in ("packed", "quantized"):
            raise ValueError(f"wire must be 'packed' or 'quantized', "
                             f"got {wire!r}")
        self.mesh = mesh
        self.num_shards = M
        self.devices = mesh.axis_devices("model")
        pack_kw = dict(pack_kw or {})
        pack_kw.setdefault("spill_lanes_per_window", 1)
        sharded, spec = pack_shards(graph, M, devices=self.devices,
                                    **pack_kw)
        # pin every static so that a repack keeps them (the per-window
        # entry bound at the trivially safe total)
        self.spec = spec._replace(max_entries_per_window=spec.num_entries)
        self.sharded = sharded
        pack_kw["num_entries"] = self.spec.num_entries
        pack_kw["max_entries_per_window"] = self.spec.num_entries
        pack_kw["overlay_capacity"] = self.spec.overlay_capacity
        pack_kw.pop("extra_entries", None)
        self._pack_kw = pack_kw
        self.delta_budget = delta_budget
        self.use_kernel = use_kernel
        self.exchange = exchange
        self.wire = wire
        self.halo = None
        if exchange == "halo":
            self.halo = build_halo(self.sharded, self.spec,
                                   capacity=halo_capacity)
            self._halo_capacity = int(self.halo.ids.shape[1])
        self.last_comm_info: dict = {}
        self.last_comm_bytes = 0
        self.loop_kw = loop_kw

    def apply_update(self, update):
        """Route Δ to its shards, apply each shard's rows, extend the
        halo with inserted boundary srcs.  Raises ``ShardCapacityError``
        (budget, spill, overlay, halo) with the structures untouched: they
        are replaced only on success."""
        from repro_torch.kernels.pagerank_spmv.shard import (
            _raise_dropped, apply_sharded, extend_halo, route_update)
        routed = route_update(update, self.spec,
                              del_budget=self.delta_budget,
                              ins_budget=self.delta_budget)
        new, dropped = apply_sharded(self.sharded, routed)
        _raise_dropped(dropped)
        new_halo = None
        if self.halo is not None:
            new_halo = extend_halo(self.halo, routed, self.spec)
        self.sharded = new
        if new_halo is not None:
            self.halo = new_halo

    def repack(self, graph):
        """Rebuild the sharded pack from ``graph`` at the pinned shapes,
        dropping the spill guarantee to the sharded minimum (1 lane) if the
        grown windows no longer fit it.  The halo is rebuilt exactly; if
        the boundary outgrew its capacity the table grows."""
        from repro_torch.kernels.pagerank_spmv.shard import (
            ShardCapacityError, build_halo, pack_shards)
        kw = dict(self._pack_kw, devices=self.devices)
        try:
            sharded, spec = pack_shards(graph, self.num_shards, **kw)
        except ValueError:
            sharded, spec = pack_shards(
                graph, self.num_shards,
                **{**kw, "spill_lanes_per_window": 1})
        spec = spec._replace(max_entries_per_window=self.spec.num_entries)
        if spec != self.spec:
            raise RuntimeError(f"repack changed the pinned statics: {spec} "
                               f"!= {self.spec}")
        self.sharded = sharded
        if self.halo is not None:
            try:
                self.halo = build_halo(self.sharded, self.spec,
                                       capacity=self._halo_capacity)
            except ShardCapacityError:
                self.halo = build_halo(self.sharded, self.spec)
                self._halo_capacity = int(self.halo.ids.shape[1])

    def solve(self, graph, init_ranks, init_affected,
              **flags) -> pr.PageRankResult:
        self.last_comm_info = {}
        res = sharded_hybrid_pagerank(
            self.mesh, self.sharded, self.spec, graph, init_ranks,
            init_affected, use_kernel=self.use_kernel, halo=self.halo,
            wire=self.wire, comm_info=self.last_comm_info,
            **{**self.loop_kw, **flags})
        self.last_comm_bytes = self.last_comm_info.get("comm_bytes", 0)
        return res
