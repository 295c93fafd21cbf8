"""Incremental walk-index maintenance from the DF ``touched`` signal (twin
of ``repro.ppr.repair``).

A stored walk is **stale** iff it occupies a touched vertex (one whose
out-edges changed, ``touched_vertices_mask``) at any hop, its source slot
included.  Every transition of a non-stale walk left an untouched vertex,
whose neighbour list is identical in Gᵗ⁻¹ and Gᵗ (same order: see
``EdgeListGraph.to_device_csr``), so the walk is kept bit for bit.

Stale walks are repaired from their first stale hop t₀: the prefix
[0..t₀] is still a valid Gᵗ trajectory, and the suffix is resampled on Gᵗ
with the walk's own per-hop draws (``ppr.walks``).  Those draws are a pure
function of (key, walk, hop), so the repaired index equals a fresh build
on Gᵗ bit for bit while only stale walks are re-walked.

Cost shape: staleness detection is one gather-reduce over the index, done
over vertex ranges so its transients stay bounded; the stale ids are
compacted with one ``torch.nonzero`` — the repair's one host read, which
also sizes the resample exactly (no power-of-two capacity); the uniforms
are drawn in plain torch and the hop recurrence runs in
``kernels.walk_repair.resample_rows`` (the CUDA kernel for a CUDA index,
its plain version for a CPU one), a chunk of walks at a time.  The result
is written into a copy of the step array: the published snapshot still
serves from the previous index until the next publish.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.graph.structure import CSRView, EdgeListGraph
from repro_torch.kernels.walk_repair.walk_repair import resample_rows
from repro_torch.ppr.walks import WalkIndex, _walk_draws, _walk_keys

# walks whose staleness is decided together (bounds the int32/bool
# transients of the [walks, L] gather)
STALE_CHUNK_WALKS = 1 << 22
# stale walks resampled per kernel launch (bounds the f32[C, L-1, 2]
# uniforms and the int64 PRNG transients)
REPAIR_CHUNK_WALKS = 1 << 22


def stale_walks(steps: torch.Tensor, touched: torch.Tensor,
                chunk_walks: int = STALE_CHUNK_WALKS
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(stale bool[V, R], first_stale_hop int32[V, R]) for a touched mask;
    the first stale hop is 0 for a walk that is not stale."""
    V, R, L = steps.shape
    stale = torch.empty((V, R), dtype=torch.bool, device=steps.device)
    t0 = torch.empty((V, R), dtype=torch.int32, device=steps.device)
    rows = max(1, chunk_walks // R)
    for a in range(0, V, rows):
        s = steps[a:a + rows]
        idx = s.clamp(0, V - 1).view(-1)                   # int32 gather
        visited = (touched.index_select(0, idx).view(s.shape) & (s >= 0))
        stale[a:a + rows] = visited.any(dim=-1)
        # argmax returns the first maximum, as jnp.argmax does
        t0[a:a + rows] = visited.to(torch.uint8).argmax(dim=-1)
    return stale, t0


def stale_ids(stale: torch.Tensor, t0: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat walk ids int64[S], their first stale hops int32[S]) in walk
    order.  ``torch.nonzero`` reads the stale count back to the host."""
    ids = torch.nonzero(stale.view(-1)).squeeze(1)
    return ids, t0.view(-1)[ids]


def walk_uniforms(key, ids: torch.Tensor, max_len: int) -> torch.Tensor:
    """f32[C, L-1, 2]: the draws of hops 1..L-1 of walks ``ids``."""
    walk_keys = _walk_keys(key, ids)
    u = torch.empty((ids.shape[0], max_len - 1, 2), dtype=torch.float32,
                    device=ids.device)
    for t in range(1, max_len):
        u[:, t - 1] = _walk_draws(walk_keys, t)
    return u


def _resample(csr: CSRView, key, steps: torch.Tensor, ids: torch.Tensor,
              t0: torch.Tensor, alpha: float,
              chunk_walks: int = REPAIR_CHUNK_WALKS) -> torch.Tensor:
    """A copy of ``steps`` with walks ``ids`` re-walked on ``csr`` from
    their first stale hops ``t0``, ``chunk_walks`` walks per launch."""
    V, R, L = steps.shape
    flat = steps.view(V * R, L)
    out = steps.clone()
    out_flat = out.view(V * R, L)
    for a in range(0, ids.shape[0], chunk_walks):
        idc = ids[a:a + chunk_walks]
        u = walk_uniforms(key, idc, L)
        out_flat[idc] = resample_rows(csr, flat[idc], t0[a:a + chunk_walks],
                                      u, alpha=alpha)
    return out


def repair_walk_index(index: WalkIndex, graph_new: EdgeListGraph,
                      touched: torch.Tensor) -> Tuple[WalkIndex, int]:
    """Repair ``index`` (valid for Gᵗ⁻¹) into the index for ``graph_new``.

    ``touched``: bool[V] from ``touched_vertices_mask`` of the applied
    batch.  Returns (repaired index, number of walks resampled); the count
    is exactly the number of stale walks.  The input index is left intact.
    Exactly one host read (the stale count).
    """
    csr_new = graph_new.to_device_csr()
    stale, t0 = stale_walks(index.steps, touched)
    ids, t0_sel = stale_ids(stale, t0)
    num_stale = int(ids.shape[0])
    if num_stale == 0:
        return dataclasses.replace(index, csr=csr_new), 0
    steps = _resample(csr_new, index.key, index.steps, ids, t0_sel,
                      index.alpha)
    return dataclasses.replace(index, steps=steps, csr=csr_new), num_stale
