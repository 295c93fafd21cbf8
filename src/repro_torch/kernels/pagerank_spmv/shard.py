"""Window-range sharding of ``PackedGraph`` over a mesh's ``model`` axis
(twin of ``repro.kernels.pagerank_spmv.shard``).

Shard *s* of *S* owns global windows ``[s·wps, (s+1)·wps)`` (``wps``
windows a shard, the window count padded up to ``S·wps``), the blocked
analogue of the dst-range ownership of ``graph/partition.py``: every
in-edge of a vertex lives on exactly one shard, so the shards'
contributions have disjoint support and reassemble exactly.

Each shard is a ``PackedGraph`` of its own over the shard's local vertex
range (``num_vertices = wps·vb``, windows and ``dst`` rebased) except that
``src`` stays **global**: sources are gathered from a full-width rank
vector, destinations are shard-local.  Because ``pack_blocks`` and the
packed update key edges as ``src·num_vertices + dst``, the convention
keeps keys injective and the unmodified incremental update correct per
shard.  One controller drives the shards (``launch/mesh.py``): shard
*s*'s tensors live on its mesh device, and ``ShardedPacked`` holds the S
structures (the reference stacks them on a leading axis;
``ShardedPacked.stacked`` gives that view on the host).

A micro-batch's deltas go to their owning shard by dst (``route_update``):
per shard, the matching rows are stably compacted into a per-shard
budget (default the whole batch, so any batch fits).  Overflowing a
smaller budget is a checked ``ShardCapacityError``, never a silent
truncation, as are a window's spill lanes, the locator overlay and the
halo table.

``frontier_spmv_shard`` (``frontier_spmv_padded`` itself) launches the
port's ``frontier_spmv`` kernel on one shard: its rsc spans every vertex
(src is global), its output only the shard's windows.  Each shard's
chunk plan is cached with its packed structure (``segment_ops/plan.py``)
and goes with it on a repack.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import note_host_syncs
from repro_torch.graph.dynamic import BatchUpdate, first_of_equals
from repro_torch.graph.structure import EdgeListGraph
from repro_torch.kernels.pagerank_spmv.pagerank_spmv import (
    DEFAULT_BE, DEFAULT_VB, PackedGraph, frontier_spmv_padded, pack_blocks)
from repro_torch.kernels.pagerank_spmv.update import _apply_batch_packed

__all__ = ["ShardSpec", "ShardedPacked", "ShardCapacityError", "HaloSpec",
           "pack_shards", "route_update", "apply_sharded",
           "apply_batch_sharded_host", "frontier_spmv_shard",
           "sharded_edge_set",
           "build_halo", "extend_halo", "halo_slots", "halo_occupancy"]

FIELDS = ("src", "dst_rel", "valid", "window", "entry_start", "sorted_key",
          "sorted_lane", "ovl_key", "ovl_lane")


class ShardCapacityError(ValueError):
    """A checked sharded-capacity overflow (delta budget, spill lanes,
    locator overlay or halo).  ``shards`` names the shards that
    overflowed."""

    def __init__(self, message: str, shards: tuple = ()):
        super().__init__(message)
        self.shards = tuple(shards)


class ShardSpec(NamedTuple):
    """Static geometry of a sharded pack.

    Shard *s* owns global windows ``[s·wps, (s+1)·wps)``, i.e. global
    vertices ``[s·wps·vb, (s+1)·wps·vb)``.
    """

    num_shards: int
    windows_per_shard: int
    vb: int
    be: int
    num_vertices: int            # global V (<= num_shards·wps·vb)
    num_entries: int             # per-shard entry capacity (equal shapes)
    max_entries_per_window: int
    overlay_capacity: int

    @property
    def vertices_per_shard(self) -> int:
        return self.windows_per_shard * self.vb

    @property
    def padded_vertices(self) -> int:
        return self.num_shards * self.vertices_per_shard


@dataclasses.dataclass(frozen=True)
class ShardedPacked:
    """The S per-shard ``PackedGraph``s, shard *s* on its mesh device.
    ``window`` ids and ``dst_rel`` windows are shard-local, ``src`` is
    global."""

    shards: tuple

    @property
    def devices(self) -> list:
        return [p.device for p in self.shards]

    def stacked(self, field: str) -> np.ndarray:
        """The reference's ``[S, ...]`` leaf ``field``, on the host."""
        note_host_syncs(len(self.shards))
        return np.stack([getattr(p, field).cpu().numpy()
                         for p in self.shards])


def sharded_edge_set(sharded: ShardedPacked, spec: ShardSpec) -> set:
    """Global live (src, dst) pairs across all shards."""
    out: set = set()
    vps = spec.vertices_per_shard
    for s, p in enumerate(sharded.shards):
        src = p.src.cpu().numpy()
        dst = (p.window.cpu().numpy()[:, None] * spec.vb
               + p.dst_rel.cpu().numpy() + s * vps)
        live = p.valid.cpu().numpy() > 0
        out |= set(zip(src[live].tolist(), dst[live].tolist()))
    return out


# ---------------------------------------------------------------------------
# host-side pack
# ---------------------------------------------------------------------------

def pack_shards(graph: EdgeListGraph, num_shards: int, *,
                be: int = DEFAULT_BE, vb: int = DEFAULT_VB,
                spill_lanes_per_window: int = 1,
                num_entries: Optional[int] = None,
                extra_entries: int = 0,
                overlay_capacity: int = 1024,
                max_entries_per_window: Optional[int] = None,
                devices: Optional[Sequence] = None
                ) -> tuple[ShardedPacked, ShardSpec]:
    """Partition ``graph`` into S window-range shards, each packed with
    ``pack_blocks`` at one shared per-shard entry capacity (host NumPy;
    the reference's arithmetic).

    ``num_entries`` pins the per-shard capacity; otherwise it is the
    widest shard's requirement plus ``extra_entries`` **total** headroom
    spread evenly over the shards.  ``spill_lanes_per_window >= 1``: every
    owned window must hold an entry.  ``devices``: shard s's device
    (default the graph's for every shard).
    """
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if spill_lanes_per_window < 1:
        raise ValueError("sharded packs need spill_lanes_per_window >= 1 "
                         "(every owned window must hold an entry)")
    if devices is None:
        devices = [graph.device] * num_shards
    if len(devices) != num_shards:
        raise ValueError(f"{len(devices)} devices for {num_shards} shards")
    V = graph.num_vertices
    nw = -(-V // vb)
    wps = -(-nw // num_shards)
    vps = wps * vb
    note_host_syncs(3)                     # the three reads of the graph
    src = graph.src.cpu().numpy()
    dst = graph.dst.cpu().numpy()
    valid = graph.valid.cpu().numpy()
    shard_of = dst // vps

    if num_entries is None:
        need_cap = 0
        for s in range(num_shards):
            m = valid & (shard_of == s)
            counts = np.bincount(dst[m] // vb - s * wps,
                                 minlength=wps).astype(np.int64)
            n_base = -(-counts // be)
            slack = n_base * be - counts
            need = np.maximum(0, spill_lanes_per_window - slack)
            need_cap = max(need_cap, int(np.sum(n_base + -(-need // be))))
        num_entries = need_cap + -(-max(0, extra_entries) // num_shards)

    packs = []
    for s in range(num_shards):
        m = valid & (shard_of == s)
        packs.append(pack_blocks(
            src[m], dst[m] - s * vps, np.ones(int(m.sum()), bool), vps,
            be=be, vb=vb, num_entries=num_entries,
            spill_lanes_per_window=spill_lanes_per_window,
            overlay_capacity=overlay_capacity,
            max_entries_per_window=None, device=devices[s]))
    widest = max(p.max_entries_per_window for p in packs)
    if max_entries_per_window is None:
        max_entries_per_window = widest
    elif widest > max_entries_per_window:
        raise ValueError(
            f"{widest} entries in one window exceed the pinned "
            f"max_entries_per_window {max_entries_per_window}")
    packs = [dataclasses.replace(
        p, max_entries_per_window=max_entries_per_window) for p in packs]
    spec = ShardSpec(num_shards=num_shards, windows_per_shard=wps, vb=vb,
                     be=be, num_vertices=V, num_entries=num_entries,
                     max_entries_per_window=max_entries_per_window,
                     overlay_capacity=overlay_capacity)
    return ShardedPacked(tuple(packs)), spec


# ---------------------------------------------------------------------------
# delta routing
# ---------------------------------------------------------------------------

def _route_update(update: BatchUpdate, spec: ShardSpec, del_budget: int,
                  ins_budget: int):
    """(routed BatchUpdate of [S, budget] rows, dropped deletions[S],
    dropped insertions[S]), on the update's device, no host read."""
    vps = spec.vertices_per_shard
    dev = update.del_src.device
    sids = torch.arange(spec.num_shards, dtype=torch.int32, device=dev)

    def side(srcs, dsts, mask, budget):
        m = mask[None, :] & ((dsts // vps)[None, :] == sids[:, None])
        order = torch.argsort((~m).to(torch.int8), dim=1,
                              stable=True)[:, :budget]
        kept = torch.gather(m, 1, order)
        zero = torch.zeros((), dtype=srcs.dtype, device=dev)
        return (torch.where(kept, srcs[order], zero),
                torch.where(kept, dsts[order] - sids[:, None] * vps, zero),
                kept,
                m.sum(dim=1, dtype=torch.int32)
                - kept.sum(dim=1, dtype=torch.int32))

    d_src, d_dst, d_mask, d_drop = side(update.del_src, update.del_dst,
                                        update.del_mask, del_budget)
    i_src, i_dst, i_mask, i_drop = side(update.ins_src, update.ins_dst,
                                        update.ins_mask, ins_budget)
    routed = BatchUpdate(del_src=d_src, del_dst=d_dst, del_mask=d_mask,
                         ins_src=i_src, ins_dst=i_dst, ins_mask=i_mask)
    return routed, d_drop, i_drop


def route_update(update: BatchUpdate, spec: ShardSpec, *,
                 del_budget: Optional[int] = None,
                 ins_budget: Optional[int] = None,
                 check: bool = True) -> BatchUpdate:
    """Δ -> per-shard Δ: rows land on the shard owning their dst window,
    stably compacted into ``[S, budget]`` rows with dst rebased to the
    shard.  Budgets default to the whole batch; a smaller budget that
    overflows raises ``ShardCapacityError`` (one host read, with
    ``check``), never a silent truncation."""
    if del_budget is None:
        del_budget = update.del_src.shape[0]
    if ins_budget is None:
        ins_budget = update.ins_src.shape[0]
    routed, d_drop, i_drop = _route_update(update, spec, del_budget,
                                           ins_budget)
    if check:
        note_host_syncs()
        d, i = torch.stack([d_drop, i_drop]).cpu().numpy()
        if d.sum() or i.sum():
            bad = tuple(int(s) for s in np.flatnonzero(d + i))
            raise ShardCapacityError(
                f"{int(d.sum())} deletions / {int(i.sum())} insertions "
                f"exceed the per-shard delta budget "
                f"(del={del_budget}, ins={ins_budget}) on shards {bad}; "
                "raise the budget", shards=bad)
    return routed


# ---------------------------------------------------------------------------
# per-shard incremental update
# ---------------------------------------------------------------------------

def apply_sharded(sharded: ShardedPacked, routed: BatchUpdate):
    """Each shard's ``apply_batch_packed`` on its rows of ``routed``, on
    its own device.  Returns (new ShardedPacked, dropped insertions: a
    list of one int64 device scalar a shard); the input is untouched."""
    outs, dropped = [], []
    for s, p in enumerate(sharded.shards):
        upd = BatchUpdate(*[x[s].to(p.device, non_blocking=True)
                            for x in routed])
        new, drop = _apply_batch_packed(p, upd)
        outs.append(new)
        dropped.append(drop)
    return ShardedPacked(tuple(outs)), dropped


def _raise_dropped(dropped) -> None:
    """One host read of the shards' dropped insertions; raise if any."""
    note_host_syncs()
    dev = dropped[0].device
    d = np.asarray(torch.stack([x.to(dev) for x in dropped]).cpu())
    if d.sum():
        bad = tuple(int(s) for s in np.flatnonzero(d))
        raise ShardCapacityError(
            f"{int(d.sum())} insertions exceed spill capacity of their dst "
            f"windows or the locator overlay on shards {bad}; repack with "
            "pack_shards", shards=bad)


def apply_batch_sharded_host(sharded: ShardedPacked, spec: ShardSpec,
                             update: BatchUpdate, *,
                             del_budget: Optional[int] = None,
                             ins_budget: Optional[int] = None,
                             check: bool = True) -> ShardedPacked:
    """Route, then apply each shard in turn (the reference's mesh-free
    form of the sharded update; the serve path runs the same steps)."""
    routed = route_update(update, spec, del_budget=del_budget,
                          ins_budget=ins_budget, check=check)
    new, dropped = apply_sharded(sharded, routed)
    if check:
        _raise_dropped(dropped)
    return new


# ---------------------------------------------------------------------------
# shard-local frontier-gated SpMV
# ---------------------------------------------------------------------------

# the reference's name for one shard's gated SpMV: ``frontier_spmv_padded``
# on the shard's packed structure, its rsc spanning every vertex
frontier_spmv_shard = frontier_spmv_padded


# ---------------------------------------------------------------------------
# halo: the cross-shard source boundary
# ---------------------------------------------------------------------------

class HaloSpec(NamedTuple):
    """Each shard's boundary-in set: the global src vertices whose rank
    the shard receives each iteration because they feed its windows but
    live on another shard.

    ``ids[s]`` holds shard s's halo (capacity H); the live entries are the
    ``count[s]``-long prefix, the tail is the sentinel ``S·vps``.
    Deletions leave stale entries (a few extra exchanged floats, never a
    wrong value); a repack rebuilds the table exactly.  Both tensors live
    on the first shard's device.
    """

    ids: torch.Tensor      # int32[S, H] global src ids, sentinel-padded
    count: torch.Tensor    # int32[S] live prefix length


def halo_slots(halo: HaloSpec) -> int:
    """Exchanged slots an iteration (the comm-volume unit)."""
    return int(halo.ids.shape[0] * halo.ids.shape[1])


def halo_occupancy(halo: HaloSpec) -> float:
    """Live share of the pinned halo table (a gauge): 1.0 means the next
    boundary-crossing insertion forces a capacity repack.  One host
    read."""
    slots = halo_slots(halo)
    if slots == 0:
        return 0.0
    note_host_syncs()
    return float(halo.count.sum()) / slots


def build_halo(sharded: ShardedPacked, spec: ShardSpec, *,
               capacity: Optional[int] = None,
               min_capacity: int = 8) -> HaloSpec:
    """Host-side halo from the live sharded pack: per shard, the unique
    live srcs outside its own vertex range.  ``capacity`` pins H; by
    default H is the widest shard's halo plus 25 % + 64 slots, rounded to
    a multiple of 64.  A pinned capacity below a shard's halo raises
    ``ShardCapacityError``."""
    vps = spec.vertices_per_shard
    rows = []
    for s, p in enumerate(sharded.shards):
        note_host_syncs(2)
        src = p.src.cpu().numpy().reshape(-1)
        live = p.valid.cpu().numpy().reshape(-1) > 0
        remote = np.unique(src[live & ((src < s * vps)
                                       | (src >= (s + 1) * vps))])
        rows.append(remote.astype(np.int32))
    widest = max((len(r) for r in rows), default=0)
    if capacity is None:
        capacity = max(min_capacity, -(-int(widest * 1.25 + 64) // 64) * 64)
    elif widest > capacity:
        bad = tuple(s for s, r in enumerate(rows) if len(r) > capacity)
        raise ShardCapacityError(
            f"shard halo of {widest} srcs exceeds the pinned halo "
            f"capacity {capacity} on shards {bad}; grow the halo",
            shards=bad)
    sentinel = spec.padded_vertices
    ids = np.full((spec.num_shards, capacity), sentinel, np.int32)
    for s, r in enumerate(rows):
        ids[s, : len(r)] = r
    dev = sharded.shards[0].device
    note_host_syncs(2)                     # two uploads
    return HaloSpec(ids=torch.from_numpy(ids).to(dev),
                    count=torch.tensor([len(r) for r in rows],
                                       dtype=torch.int32, device=dev))


def _extend_halo(ids: torch.Tensor, count: torch.Tensor,
                 ins_src: torch.Tensor, ins_mask: torch.Tensor, vps: int):
    """Append each routed insertion's src to its shard's halo row (skips
    own-range srcs and srcs already present; duplicates within the batch
    count once).  Returns (ids, count, dropped[S]) as new tensors; no host
    read."""
    S, H = ids.shape
    dev = ids.device
    ins_src = ins_src.to(dev)
    ins_mask = ins_mask.to(dev)
    new_ids, new_count, drops = ids.clone(), [], []
    for s in range(S):
        srcs, mask = ins_src[s], ins_mask[s]
        cand = mask & ((srcs < s * vps) | (srcs >= (s + 1) * vps))
        # membership by a binary search in the sorted row (torch.isin
        # reads sizes back to the host on the card)
        row_sorted = torch.sort(ids[s]).values
        at = torch.searchsorted(row_sorted, srcs).clamp(max=H - 1)
        keep = cand & (row_sorted[at] != srcs)
        keep = keep & first_of_equals(torch.where(
            keep, srcs.long(), torch.full((), -1, dtype=torch.int64,
                                          device=dev)))
        pos = count[s] + torch.cumsum(keep.to(torch.int32), 0) - 1
        ok = keep & (pos < H)
        row = torch.cat([new_ids[s], new_ids.new_zeros(1)])
        slot = torch.where(ok, pos.long(), torch.full_like(pos.long(), H))
        row = row.scatter(0, slot, torch.where(ok, srcs, row[slot]))
        new_ids[s] = row[:H]
        new_count.append(count[s] + ok.sum(dtype=torch.int32))
        drops.append((keep & ~ok).sum(dtype=torch.int32))
    return new_ids, torch.stack(new_count), torch.stack(drops)


def extend_halo(halo: HaloSpec, routed: BatchUpdate, spec: ShardSpec, *,
                check: bool = True) -> HaloSpec:
    """Halo upkeep for one routed micro-batch (insertions only: deletions
    leave stale slots).  Overflow is a ``ShardCapacityError`` (one host
    read, with ``check``); the stream owner repacks, which rebuilds the
    halo exactly."""
    ids, count, dropped = _extend_halo(halo.ids, halo.count,
                                       routed.ins_src, routed.ins_mask,
                                       spec.vertices_per_shard)
    if check:
        note_host_syncs()
        d = dropped.cpu().numpy()
        if d.sum():
            bad = tuple(int(s) for s in np.flatnonzero(d))
            raise ShardCapacityError(
                f"{int(d.sum())} inserted boundary srcs exceed the halo "
                f"capacity {halo.ids.shape[1]} on shards {bad}; repack "
                "with a larger halo", shards=bad)
    return HaloSpec(ids=ids, count=count)
