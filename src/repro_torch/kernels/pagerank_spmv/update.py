"""Incremental ``PackedGraph`` maintenance on the device (twin of
``repro.kernels.pagerank_spmv.update``).

``apply_batch_packed`` mirrors ``graph.dynamic.apply_batch`` on the
blocked structure, so a stream never repacks on the host per batch:

  * lookups (deletion targets, duplicate-insert checks) go through the
    edge locator: binary search over the pack-time ``sorted_key`` index
    plus a search of the insertion overlay, each candidate verified
    against the lane's current contents;
  * deletion (u, v): flip the verified lane's ``valid`` to 0;
  * insertion (u, v): the k-th kept insertion into a dst window claims
    that window's k-th free lane, and is recorded in the overlay;
  * ``window``/``entry_start``/``sorted_*`` and all shapes are untouched.

Results are bitwise the reference's.  The reference probes the overlay
with a ``[|Δ|, K]`` matrix and scans free slots with a ``[|Δ|, M]`` one
(M = entries per window, pinned to all entries by the serve engine); at
serving sizes those reach gigabytes, so here the overlay is searched by
sorting its verified keys and the free-slot scan is one cumulative sum
over entry free counts.  Both give the same lanes: a live edge sits in
exactly one lane, so every verified overlay hit names the same lane, and
a window's entries are contiguous, so its k-th free lane is found by a
binary search in the global cumulative free count.

Running out of free lanes in a window or of overlay slots is a checked
error (``PackedSpillError``, a ``ValueError``); callers repack with
``pack_graph``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import note_host_syncs
from repro_torch.graph.dynamic import BatchUpdate, first_of_equals
from repro_torch.graph.structure import EdgeListGraph
from repro_torch.kernels.pagerank_spmv.pagerank_spmv import (
    DEFAULT_BE, DEFAULT_VB, LANE_SENTINEL, PackedGraph, pack_blocks)

__all__ = ["apply_batch_packed", "pack_graph", "packed_edge_set",
           "PackedSpillError", "SPILL_ERROR"]

SPILL_ERROR = ("{n} insertions exceed spill capacity of their dst "
               "windows or the locator overlay; repack with pack_graph "
               "/ raise spill_lanes_per_window or overlay_capacity "
               "(capacity sizing: DESIGN.md §8)")


class PackedSpillError(ValueError):
    """A window's free lanes or the locator overlay ran out: the one
    error a caller answers by repacking (``pack_graph``)."""


def pack_graph(graph: EdgeListGraph, *, be: int = DEFAULT_BE,
               vb: int = DEFAULT_VB, num_entries: int | None = None,
               spill_lanes_per_window: int = 0,
               extra_entries: int = 0,
               overlay_capacity: int = 1024,
               max_entries_per_window: int | None = None) -> PackedGraph:
    """Host-side bootstrap/repack: EdgeListGraph -> PackedGraph, on the
    graph's device."""
    note_host_syncs(3)                     # the three reads of the graph
    return pack_blocks(graph.src.cpu().numpy(), graph.dst.cpu().numpy(),
                       graph.valid.cpu().numpy(), graph.num_vertices,
                       be=be, vb=vb, num_entries=num_entries,
                       spill_lanes_per_window=spill_lanes_per_window,
                       extra_entries=extra_entries,
                       overlay_capacity=overlay_capacity,
                       max_entries_per_window=max_entries_per_window,
                       device=graph.device)


def packed_edge_set(packed: PackedGraph) -> set:
    """Host-side set of live (src, dst) pairs — the parity oracle."""
    src = packed.src.cpu().numpy()
    dst = (packed.window.cpu().numpy()[:, None] * packed.vb
           + packed.dst_rel.cpu().numpy())
    live = packed.valid.cpu().numpy() > 0
    return set(zip(src[live].tolist(), dst[live].tolist()))


def _apply_batch_packed(packed: PackedGraph, update: BatchUpdate):
    """(new PackedGraph, int64[] dropped-insertion count); new tensors,
    the input is untouched."""
    V = packed.num_vertices
    vb, be = packed.vb, packed.be
    ne = packed.num_entries
    L = ne * be                                        # lanes; L = absent
    K = packed.overlay_capacity
    dev = packed.device
    src_flat = packed.src.reshape(-1)
    rel_flat = packed.dst_rel.reshape(-1)
    valid = packed.valid.reshape(-1)
    window = packed.window.long()

    def lane_key(lane):
        """Current (src·V + dst) key of each flat lane."""
        d = window[lane // be] * vb + rel_flat[lane].long()
        return src_flat[lane].long() * V + d

    def locate(key, live):
        """Flat lane currently holding each key's edge, else L."""
        pos = torch.searchsorted(packed.sorted_key, key).clamp(0, L - 1)
        base_lane = packed.sorted_lane[pos].long()
        base_ok = (lane_key(base_lane) == key) & (live[base_lane] > 0)
        # overlay: keep the slots whose lane still holds their edge, then
        # binary-search the query keys among them
        ovl_lane = packed.ovl_lane.long().clamp(0, L - 1)
        ok = ((packed.ovl_key == lane_key(ovl_lane))
              & (live[ovl_lane] > 0))
        okey, perm = torch.sort(torch.where(
            ok, packed.ovl_key,
            torch.full((), LANE_SENTINEL, dtype=torch.int64, device=dev)))
        opos = torch.searchsorted(okey, key).clamp(0, K - 1)
        ovl_hit = okey[opos] == key
        hit_lane = ovl_lane[perm[opos]]
        full = torch.full((), L, dtype=torch.int64, device=dev)
        return torch.where(base_ok, base_lane,
                           torch.where(ovl_hit, hit_lane, full))

    # ---- deletions ------------------------------------------------------
    del_key = update.del_src.long() * V + update.del_dst.long()
    del_t = locate(del_key, valid)
    valid = valid.clone()
    # the mask selection reads its size back; index_fill_ passes 0.0 to
    # the kernel (an indexed assignment of it would be an upload)
    valid.index_fill_(0, del_t[update.del_mask & (del_t < L)], 0.0)
    note_host_syncs()

    # ---- insertions -----------------------------------------------------
    ins_w = (update.ins_dst // vb).long()
    ins_rel = update.ins_dst - (ins_w * vb).to(torch.int32)
    ins_key = update.ins_src.long() * V + update.ins_dst.long()
    # duplicate-of-live check against the post-deletion lanes, so a
    # delete+reinsert of one edge within a batch lands back in a window
    dup = locate(ins_key, valid) < L
    keep = update.ins_mask & ~dup
    # de-dup within the batch itself (same scheme as apply_batch)
    keep = keep & first_of_equals(torch.where(
        keep, ins_key, torch.full((), -1, dtype=torch.int64, device=dev)))
    # k-th kept insertion into a window -> that window's k-th free lane
    icap = keep.shape[0]
    i = torch.arange(icap, device=dev)
    rank = (keep[None, :] & (ins_w[None, :] == ins_w[:, None])
            & (i[None, :] < i[:, None])).sum(dim=1)

    # free lanes per entry, cumulated over all entries: a window's
    # entries are contiguous, so its free lanes are a range of the sum
    free_cnt = (valid.reshape(ne, be) <= 0).sum(dim=1)
    cum = torch.cumsum(free_cnt, 0)
    cum0 = torch.cat([cum.new_zeros(1), cum])          # free before entry e
    start = packed.entry_start.long()[ins_w]
    stop = packed.entry_start.long()[ins_w + 1]
    before = cum0[start]
    ok_window = keep & (rank < cum0[stop] - before)
    entry = torch.searchsorted(cum, before + rank, right=True)
    entry = entry.clamp(0, ne - 1)
    within = rank - (cum0[entry] - before)
    rowfree = valid.reshape(ne, be)[entry] <= 0                 # [I, BE]
    rowcum = torch.cumsum(rowfree.to(torch.int32), dim=1)
    lane_in = torch.argmax((rowcum == (within + 1)[:, None]).to(torch.int8),
                           dim=1)
    tgt = entry * be + lane_in

    # overlay append (so later batches can locate these edges); overlay
    # slots, like lanes, are a checked capacity
    used = (packed.ovl_key != LANE_SENTINEL).sum()
    grank = torch.cumsum(ok_window.to(torch.int64), 0) - 1
    slot = used + grank
    final_ok = ok_window & (slot < K)
    dropped = ((keep & ~ok_window) | (ok_window & ~final_ok)).sum()
    ovl_key = packed.ovl_key.clone()
    ovl_lane = packed.ovl_lane.clone()
    ovl_key[slot[final_ok]] = ins_key[final_ok]
    ovl_lane[slot[final_ok]] = tgt[final_ok].to(torch.int32)

    t = tgt[final_ok]
    src = src_flat.clone()
    dst_rel = rel_flat.clone()
    src[t] = update.ins_src[final_ok]
    dst_rel[t] = ins_rel[final_ok]
    valid.index_fill_(0, t, 1.0)
    # the seven boolean-mask selections since the deletions each read
    # their size back
    note_host_syncs(7)
    new = dataclasses.replace(packed, src=src.reshape(ne, be),
                              dst_rel=dst_rel.reshape(ne, be),
                              valid=valid.reshape(ne, be),
                              ovl_key=ovl_key, ovl_lane=ovl_lane)
    return new, dropped


def apply_batch_packed(packed: PackedGraph, update: BatchUpdate, *,
                       check: bool = True) -> PackedGraph:
    """Packedᵗ⁻¹, Δᵗ → Packedᵗ (shapes unchanged).

    ``check=True`` reads one scalar to raise on spill/overlay exhaustion
    — skip it only when the caller audits overflow out of band.
    """
    new, dropped = _apply_batch_packed(packed, update)
    if check:
        note_host_syncs()
        n = int(dropped)
        if n:
            raise PackedSpillError(SPILL_ERROR.format(n=n))
    return new
