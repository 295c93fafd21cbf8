"""Dynamic-graph batch updates (twin of ``repro.graph.dynamic``, paper §3.2).

A batch update Δᵗ = (Δᵗ⁻ deletions, Δᵗ⁺ insertions) transforms Gᵗ⁻¹ → Gᵗ.
Updates are capacity-padded so every batch of a stream has one shape.

  * deletion (u, v): mark the matching live slot invalid (no-op if absent);
  * insertion (u, v): claim a free slot; duplicates of live edges and
    in-batch duplicates are skipped; vertices are never added or removed;
  * self-loops are implicit, so batches never carry them.

Slot assignment is bitwise the reference's: the i-th kept insertion (in
batch order) claims the i-th free slot (in slot order).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.structure import EdgeListGraph


class BatchUpdate(NamedTuple):
    """Padded edge-update batch. Invalid rows carry mask False."""

    del_src: torch.Tensor   # int32[D_cap]
    del_dst: torch.Tensor   # int32[D_cap]
    del_mask: torch.Tensor  # bool[D_cap]
    ins_src: torch.Tensor   # int32[I_cap]
    ins_dst: torch.Tensor   # int32[I_cap]
    ins_mask: torch.Tensor  # bool[I_cap]


def make_batch_update(deletions: np.ndarray, insertions: np.ndarray,
                      del_capacity: int, ins_capacity: int,
                      device: DeviceLike = None) -> BatchUpdate:
    """Host-side helper: (k,2) int arrays -> padded BatchUpdate."""
    device = resolve_device(device)
    deletions = np.asarray(deletions, np.int32).reshape(-1, 2)
    insertions = np.asarray(insertions, np.int32).reshape(-1, 2)
    nd, ni = len(deletions), len(insertions)
    if nd > del_capacity or ni > ins_capacity:
        raise ValueError("update exceeds capacity")

    def pad(a, cap):
        out = np.zeros((cap,), np.int32)
        out[: len(a)] = a
        return torch.from_numpy(out).to(device)

    def mask(n, cap):
        return torch.from_numpy(np.arange(cap) < n).to(device)

    return BatchUpdate(
        del_src=pad(deletions[:, 0], del_capacity),
        del_dst=pad(deletions[:, 1], del_capacity),
        del_mask=mask(nd, del_capacity),
        ins_src=pad(insertions[:, 0], ins_capacity),
        ins_dst=pad(insertions[:, 1], ins_capacity),
        ins_mask=mask(ni, ins_capacity),
    )


def _edge_key(src: torch.Tensor, dst: torch.Tensor,
              num_vertices: int) -> torch.Tensor:
    return src.to(torch.int64) * num_vertices + dst.to(torch.int64)


def _lookup(sorted_keys: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """bool: ``keys`` present in the ascending ``sorted_keys``."""
    pos = torch.searchsorted(sorted_keys, keys)
    pos = pos.clamp(0, sorted_keys.shape[0] - 1)
    return sorted_keys[pos] == keys


def first_of_equals(key: torch.Tensor) -> torch.Tensor:
    """bool: row i holds the first (in row order) of its non-negative key
    value; rows with key < 0 are never first."""
    sorted_key, order = torch.sort(key, stable=True)
    first = torch.ones_like(sorted_key, dtype=torch.bool)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    keep = torch.zeros_like(first)
    keep[order] = first & (sorted_key >= 0)
    return keep


def apply_batch(graph: EdgeListGraph, update: BatchUpdate) -> EdgeListGraph:
    """Pure function Gᵗ⁻¹, Δᵗ → Gᵗ (new tensors; the input is untouched).

    Deletions: membership test by binary search over the sorted batch
    keys.  Insertions: the i-th kept insertion claims the i-th free slot.
    """
    V = graph.num_vertices
    E_cap = graph.edge_capacity
    dev = graph.device
    # ---- deletions -------------------------------------------------------
    live_key = _edge_key(graph.src, graph.dst, V)
    del_key = torch.where(update.del_mask,
                          _edge_key(update.del_src, update.del_dst, V),
                          torch.full((), -1, dtype=torch.int64, device=dev))
    is_deleted = _lookup(torch.sort(del_key).values, live_key) & graph.valid
    valid = graph.valid & ~is_deleted

    # ---- insertions ------------------------------------------------------
    # skip inserts that already exist (the paper's graphs are simple)
    live_key_after = torch.where(
        valid, live_key, torch.full((), -2, dtype=torch.int64, device=dev))
    ins_key = _edge_key(update.ins_src, update.ins_dst, V)
    already = _lookup(torch.sort(live_key_after).values, ins_key)
    ins_mask = update.ins_mask & ~already
    # de-dup within the batch itself: keep the first among equals
    ins_mask = ins_mask & first_of_equals(torch.where(
        ins_mask, ins_key, torch.full((), -1, dtype=torch.int64,
                                      device=dev)))

    # free-slot compaction: i-th masked insertion -> i-th free slot
    free = ~valid
    free_rank = torch.cumsum(free.to(torch.int32), 0) - 1
    ins_rank = torch.cumsum(ins_mask.to(torch.int32), 0) - 1
    slots = torch.arange(E_cap, dtype=torch.int32, device=dev)
    slot_of_rank = torch.full((E_cap,), E_cap, dtype=torch.int32,
                              device=dev)
    slot_of_rank[free_rank[free]] = slots[free]
    target = slot_of_rank[ins_rank.clamp(0, E_cap - 1)]
    ok = ins_mask & (target < E_cap)       # E_cap = no free slot: dropped
    tgt = target[ok].long()
    src = graph.src.clone()
    dst = graph.dst.clone()
    new_valid = valid.clone()
    src[tgt] = update.ins_src[ok]
    dst[tgt] = update.ins_dst[ok]
    new_valid[tgt] = True
    return dataclasses.replace(
        graph, src=src, dst=dst, valid=new_valid,
        num_edges=new_valid.sum(dtype=torch.int32))


def touched_vertices_mask(update: BatchUpdate,
                          num_vertices: int) -> torch.Tensor:
    """bool[V]: u-endpoints of every edge in Δ — seeds for frontier marking.

    Masked-out slots are sent to a spare slot V rather than filtered out,
    so no host read sizes the index."""
    m = torch.zeros(num_vertices + 1, dtype=torch.bool,
                    device=update.del_src.device)
    for src, mask in ((update.del_src, update.del_mask),
                      (update.ins_src, update.ins_mask)):
        m[torch.where(mask, src, num_vertices).long()] = True
    return m[:num_vertices]
