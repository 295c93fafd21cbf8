"""Decay-terminated random-walk index for Monte-Carlo personalized PageRank
(twin of ``repro.ppr.walks``).

The index stores R short random walks per vertex; visit counts over the
walks from a seed estimate its PPR vector (``ppr.query``), and the stored
walks are repaired per edge batch (``ppr.repair``) instead of rebuilt
(Bahmani et al., *Fast Incremental and Personalized PageRank*).

Layout:

  ``steps: int32[V, R, L]``   vertex occupied at hop t; slot 0 is the
                              source itself; ``-1`` once the walk has
                              decay-terminated (the sentinel is the mask).

Transition: from u, pick uniformly among u's ``deg`` valid out-edges plus
the implicit self-loop (slot ``deg``), i.e. P(stay) = 1/(deg+1); continue
with probability ``alpha`` per hop — the exact solvers' transition.

PRNG discipline: the randomness of walk i at hop t is
``fold_in(fold_in(key, i), t)`` (``ppr.threefry``, bit-identical to
``jax.random``), a pure function of (key, walk id, hop).  A walk's
trajectory is therefore a pure function of (graph, key): rebuilding with
the same key reproduces the index bit for bit, and repairing stale
suffixes reproduces exactly what a fresh build on the new graph draws.
The build goes over vertex ranges with global walk ids, so its result is
the same for every ``chunk_vertices``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.pagerank import ALPHA
from repro_torch.graph.structure import CSRView, EdgeListGraph
from repro_torch.ppr import threefry

DEFAULT_NUM_WALKS = 32
DEFAULT_MAX_LEN = 20
# walks sampled together in one build pass: bounds the int64 PRNG
# transients (~8 B per walk per live temporary) at any index size
BUILD_CHUNK_WALKS = 1 << 22


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Build-time knobs; hold one of these to (re)build identical indexes."""

    num_walks: int = DEFAULT_NUM_WALKS    # R walks per vertex
    max_len: int = DEFAULT_MAX_LEN        # L slots incl. the source slot
    alpha: float = ALPHA                  # continue probability (= damping)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class WalkIndex:
    """R decay-terminated walks per vertex, with the CSR view of the graph
    they were sampled on (queries read seed neighbour lists from it)."""

    steps: torch.Tensor            # int32[V, R, L]; -1 = terminated
    csr: CSRView                   # adjacency the walks are valid for
    key: Tuple[int, int]           # base PRNG key: two uint32 words
    num_walks: int
    max_len: int
    alpha: float

    @property
    def num_vertices(self) -> int:
        return self.steps.shape[0]

    @property
    def device(self) -> torch.device:
        return self.steps.device

    def mask(self) -> torch.Tensor:
        """bool[V, R, L]: positions actually occupied."""
        return self.steps >= 0

    def nbytes(self) -> int:
        return self.steps.numel() * 4


def _walk_keys(base_key, walk_ids: torch.Tensor) -> threefry.Key:
    """Per-walk keys fold_in(base_key, walk id); ``walk_ids`` are int64
    taken modulo 2**32, as the reference's uint32 ids are."""
    return threefry.fold_in(base_key, walk_ids)


def _walk_draws(walk_keys: threefry.Key, t: int) -> torch.Tensor:
    """f32[N, 2] uniforms for (walk, hop t): [:, 0] continue, [:, 1]
    choice — a pure function of (base key, walk id, hop)."""
    return threefry.uniform2(threefry.fold_in(walk_keys, t))


def _transition(csr: CSRView, cur: torch.Tensor,
                choice: torch.Tensor) -> torch.Tensor:
    """One hop from ``cur``: slot j ~ U{0..deg}, slot deg = self-loop.

    ``j = int(choice * f32(deg + 1))`` is one IEEE float32 multiply and a
    truncating convert, the arithmetic the repair kernel repeats."""
    cur_l = cur.long()
    deg = csr.deg[cur_l]
    j = torch.minimum((choice * (deg + 1).to(torch.float32))
                      .to(torch.int32), deg)
    idx = (csr.indptr[cur_l] + j).clamp(0, csr.indices.shape[0] - 1)
    return torch.where(j >= deg, cur, csr.indices[idx.long()])


def _build_steps_range(csr: CSRView, key, v_start: int, num_local: int,
                       num_walks: int, max_len: int,
                       alpha: float) -> torch.Tensor:
    """int32[num_local, R, L]: rows [v_start, v_start + num_local) of the
    full build, sampled with global walk ids (v·R + r)."""
    R, L = num_walks, max_len
    dev = csr.deg.device
    n_loc = num_local * R
    gids = v_start * R + torch.arange(n_loc, dtype=torch.int64, device=dev)
    walk_keys = _walk_keys(key, gids)
    cur = (v_start + torch.arange(num_local, dtype=torch.int32, device=dev)
           ).repeat_interleave(R)
    a32 = torch.tensor(alpha, dtype=torch.float32, device=dev)
    out = torch.empty((n_loc, L), dtype=torch.int32, device=dev)
    out[:, 0] = cur
    alive = torch.ones(n_loc, dtype=torch.bool, device=dev)
    for t in range(1, L):
        u = _walk_draws(walk_keys, t)
        alive = alive & (u[:, 0] < a32)
        nxt = _transition(csr, cur, u[:, 1])
        cur = torch.where(alive, nxt, cur)
        out[:, t] = torch.where(alive, cur, -1)
    return out.view(num_local, R, L)


def build_walk_index(graph: EdgeListGraph,
                     config: IndexConfig = IndexConfig(),
                     chunk_vertices: Optional[int] = None) -> WalkIndex:
    """Sample the full index on ``graph`` (on the graph's device), one
    vertex range of ``chunk_vertices`` at a time (default: as many as
    ``BUILD_CHUNK_WALKS`` walks)."""
    key = threefry.prng_key(config.seed)
    csr = graph.to_device_csr()
    V, R, L = graph.num_vertices, config.num_walks, config.max_len
    if chunk_vertices is None:
        chunk_vertices = max(1, BUILD_CHUNK_WALKS // R)
    steps = torch.empty((V, R, L), dtype=torch.int32, device=graph.device)
    for v0 in range(0, V, chunk_vertices):
        n = min(chunk_vertices, V - v0)
        steps[v0:v0 + n] = _build_steps_range(csr, key, v0, n, R, L,
                                              config.alpha)
    return WalkIndex(steps=steps, csr=csr, key=key, num_walks=R,
                     max_len=L, alpha=config.alpha)
