"""Graph + batch-update generators (host-side NumPy, deterministic).

The port's own copy of ``repro.graph.generators``: the same seeds give the
same arrays.  ``rmat_edges`` dedups through a 1-D int64 key, which yields
the same sorted edge set as ``np.unique(axis=0)`` and is fast enough for
2**21-vertex graphs.

Covers both of the paper's evaluation regimes:
  * §5.1.4 temporal replay: a timestamp-ordered edge stream, 90% preloaded,
    remainder replayed in 100 consecutive batches (``TemporalStream``).
  * §5.2.2 random updates on large static graphs: 80% uniformly-random
    insertions + 20% uniform deletions of existing edges
    (``random_batch_update``).

RMAT gives power-law "web-like" graphs; ER gives uniform "road-like" low
locality; BA gives preferential-attachment "social-like" graphs — matching
the paper's web/social/road/k-mer dataset spread without shipping datasets.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def rmat_edges(scale: int, edge_factor: int, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19
               ) -> Tuple[np.ndarray, int]:
    """R-MAT power-law digraph: 2**scale vertices, edge_factor·V edges."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edge_factor * n
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for bit in range(scale):
        r = rng.random(m)
        src_bit = (r >= a + b).astype(np.int64)
        r2 = rng.random(m)
        thresh = np.where(src_bit == 0, a / (a + b), c / (1 - a - b))
        dst_bit = (r2 >= thresh).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    key = np.unique(src * n + dst)                # == unique(axis=0) order
    edges = np.stack([key // n, key % n], 1)
    edges = edges[edges[:, 0] != edges[:, 1]]     # self-loops are implicit
    return edges.astype(np.int32), n


def erdos_renyi_edges(n: int, m: int, seed: int = 0) -> Tuple[np.ndarray, int]:
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(int(m * 1.2), 2), dtype=np.int64)
    edges = np.unique(edges, axis=0)
    edges = edges[edges[:, 0] != edges[:, 1]][:m]
    return edges.astype(np.int32), n


def barabasi_albert_edges(n: int, m_per_node: int, seed: int = 0
                          ) -> Tuple[np.ndarray, int]:
    """Preferential attachment; directed new->target, social-network-like."""
    rng = np.random.default_rng(seed)
    targets = list(range(m_per_node))
    repeated: list[int] = list(range(m_per_node))
    edges = []
    for v in range(m_per_node, n):
        for t in targets:
            edges.append((v, t))
        repeated.extend(targets)
        repeated.extend([v] * m_per_node)
        idx = rng.integers(0, len(repeated), size=m_per_node)
        targets = list({repeated[i] for i in idx})[:m_per_node]
        while len(targets) < m_per_node:
            targets.append(int(rng.integers(0, v + 1)))
    e = np.unique(np.asarray(edges, np.int64), axis=0)
    e = e[e[:, 0] != e[:, 1]]
    return e.astype(np.int32), n


def grid_edges(side: int, seed: int = 0) -> Tuple[np.ndarray, int]:
    """2-D lattice digraph (road-network-like: avg degree ~4, diameter
    ~2·side).  The high-diameter regime where frontier approaches win
    biggest (paper §5.2.2: road/k-mer graphs)."""
    n = side * side
    idx = np.arange(n).reshape(side, side)
    e = []
    e.append(np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1))
    e.append(np.stack([idx[:, 1:].ravel(), idx[:, :-1].ravel()], 1))
    e.append(np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1))
    e.append(np.stack([idx[1:, :].ravel(), idx[:-1, :].ravel()], 1))
    edges = np.concatenate(e).astype(np.int32)
    return edges, n


def temporal_stream_edges(n: int, m: int, seed: int = 0,
                          locality: float = 0.9,
                          n_communities: int = 64) -> np.ndarray:
    """Timestamp-ordered edge stream with *localised* updates.

    Real-world dynamic graphs (paper §5.2.3) concentrate updates in
    specific regions, and the graphs have community structure that keeps
    rank perturbations from reaching most of the graph.  Model: vertices
    belong to Zipf-sized communities; an edge stays inside its source's
    community with prob. ``locality``, and consecutive edges reuse a
    drifting hot community.  Duplicates allowed (|E_T| ≫ |E| like SNAP).
    """
    rng = np.random.default_rng(seed)
    # Zipf community sizes
    sizes = 1.0 / np.arange(1, n_communities + 1) ** 0.8
    bounds = np.concatenate([[0], np.cumsum(sizes / sizes.sum())]) * n
    bounds = bounds.astype(np.int64)
    bounds[-1] = n

    def sample_dst(c, k):
        lo, hi = bounds[c], max(bounds[c] + 1, bounds[c + 1])
        return rng.integers(lo, hi, size=k)

    def sample_src(c):
        # Zipf-skewed source: few vertices per community source most
        # edges (SX: most users never answer) -> most vertices are pure
        # sinks whose only out-edge is the self-loop, which is what stops
        # frontier propagation on real graphs
        lo, hi = bounds[c], max(bounds[c] + 1, bounds[c + 1])
        size = hi - lo
        r = rng.zipf(1.6)
        return lo + min(r - 1, size - 1)

    src = np.zeros(m, np.int32)
    dst = np.zeros(m, np.int32)
    hot = rng.integers(0, n_communities)
    for i in range(m):
        if rng.random() > 0.98:                 # hot community drifts
            hot = rng.integers(0, n_communities)
        c = hot if rng.random() < locality else \
            rng.integers(0, n_communities)
        s = sample_src(c)
        c2 = c if rng.random() < locality else \
            rng.integers(0, n_communities)
        d = sample_dst(c2, 1)[0]
        if d == s:
            d = bounds[c2] + (s + 1 - bounds[c2]) % max(
                1, bounds[c2 + 1] - bounds[c2])
        src[i], dst[i] = s, d
    return np.stack([src, dst], 1)


def random_batch_update(edges_live: np.ndarray, n: int, batch_size: int,
                        seed: int = 0, frac_insert: float = 0.8
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Paper §5.2.2: 80% random insertions, 20% deletions of existing edges."""
    rng = np.random.default_rng(seed)
    n_ins = int(round(batch_size * frac_insert))
    n_del = batch_size - n_ins
    ins = rng.integers(0, n, size=(n_ins, 2), dtype=np.int64)
    ins = ins[ins[:, 0] != ins[:, 1]]
    if len(edges_live) and n_del:
        idx = rng.choice(len(edges_live), size=min(n_del, len(edges_live)),
                         replace=False)
        dele = edges_live[idx]
    else:
        dele = np.zeros((0, 2), np.int64)
    return dele.astype(np.int32), ins.astype(np.int32)


class TemporalStream:
    """Paper §5.1.4 replay harness: 90% preload, then 100 insert batches."""

    def __init__(self, edges_temporal: np.ndarray, num_vertices: int,
                 batch_frac: float, num_batches: int = 100):
        self.edges = np.asarray(edges_temporal, np.int32)
        self.n = num_vertices
        total = len(self.edges)
        self.batch_size = max(1, int(round(batch_frac * total)))
        self.preload_end = int(0.9 * total)
        self.num_batches = min(
            num_batches,
            max(1, (total - self.preload_end) // self.batch_size))

    def preload_edges(self) -> np.ndarray:
        return self.edges[: self.preload_end]

    def batch(self, i: int) -> np.ndarray:
        lo = self.preload_end + i * self.batch_size
        return self.edges[lo: lo + self.batch_size]


STREAM_REGIMES = ("insert_only", "mixed", "delete_heavy")


def update_stream(scale: int = 6, edge_factor: int = 4, *,
                  regime: str = "mixed", graph: str = "rmat",
                  num_batches: int = 8, batch_size: int = 24,
                  seed: int = 0) -> Tuple[np.ndarray, int, list]:
    """Seeded dynamic-update stream for cross-engine differential testing.

    Returns ``(init_edges (k,2) int32, n, batches)`` where each batch is
    a ``(deletions (a,2), insertions (b,2))`` pair.  The generator keeps
    a host-side live-edge set so deletions target edges that exist;
    every batch also mixes in the no-op edge cases incremental engines
    must agree on (absent-edge deletions, duplicate-of-live insertions,
    in-batch duplicates, delete-then-reinsert of the same edge).

    ``graph``: "rmat" (skewed power-law, 2^scale vertices) or "uniform"
    (Erdős–Rényi at the same vertex/edge counts).  ``regime`` sets the
    deletion fraction per batch: "insert_only" 0, "mixed" ~1/3,
    "delete_heavy" ~2/3.
    """
    if regime not in STREAM_REGIMES:
        raise ValueError(f"unknown regime {regime!r}; one of "
                         f"{STREAM_REGIMES}")
    if graph == "rmat":
        edges, n = rmat_edges(scale, edge_factor, seed=seed)
    elif graph == "uniform":
        n = 2 ** scale
        edges, _ = erdos_renyi_edges(n, n * edge_factor, seed=seed)
    else:
        raise ValueError(f"unknown graph kind {graph!r}")
    edges = np.unique(edges, axis=0)
    edges = edges[edges[:, 0] != edges[:, 1]].astype(np.int32)
    rng = np.random.default_rng(seed + 1)
    live = {tuple(e) for e in edges.tolist()}

    n_del = {"insert_only": 0, "mixed": batch_size // 3,
             "delete_heavy": (2 * batch_size) // 3}[regime]
    n_ins = batch_size - n_del
    batches = []
    for _ in range(num_batches):
        dels = []
        if n_del and live:
            pool = sorted(live)
            picks = rng.choice(len(pool), size=min(n_del, len(pool)),
                               replace=False)
            dels = [pool[i] for i in picks]
        # absent-edge deletion: must be a no-op on every engine
        u, v = rng.integers(0, n, size=2)
        if u != v and (int(u), int(v)) not in live:
            dels.append((int(u), int(v)))
        e = rng.integers(0, n, size=(n_ins, 2))
        ins = [tuple(x) for x in e[e[:, 0] != e[:, 1]].tolist()]
        if ins:
            ins.append(ins[0])                    # in-batch duplicate
        if dels:
            ins.append(dels[0])                   # delete -> reinsert
        live -= set(dels)
        live |= set(ins)
        batches.append((
            np.asarray(dels, np.int32).reshape(-1, 2),
            np.asarray(ins, np.int32).reshape(-1, 2)))
    return edges, n, batches
