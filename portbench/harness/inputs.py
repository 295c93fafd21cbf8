"""Everything a run feeds the program, made from ``--seed`` on the device.

One ``torch.Generator`` on the run's device, seeded with ``--seed``,
draws in a fixed sequence: the graph, the deletions, the insertions, the
query vertices and the order of the query arrivals.  The same seed on
the same device gives the same inputs.

  * graph: Graph500 R-MAT (Chakrabarti, Zhan and Faloutsos, SDM 2004;
    Graph500 specification: A, B, C = 0.57, 0.19, 0.19), 2^scale
    vertices, edge_factor * 2^scale draws, one quadrant draw a level,
    the vertex labels then permuted at random as the specification does
    (so hubs do not cluster at low ids), duplicates and self-loops
    removed; the live edges take the first slots in ascending (src, dst)
    order and ``edge_capacity_factor`` sets
    the slots (never fewer than the feed can need);
  * feed: batches of ``batch_events`` events, ``insert_share`` of them
    insertions of edges drawn uniformly over vertex pairs (none present
    at the start, none repeated) and the rest deletions of edges live at
    the start (each at most once); so every deletion meets a live edge
    and every insertion a new one, and each batch moves the same number
    of edges;
  * queries (a mix with a ``queries`` section): a Poisson stream at
    ``rate_per_s``, its gaps drawn once from the mix's own
    ``arrival_seed`` and put in an order drawn from ``--seed``, so every
    seed offers the same arrivals; each query's vertex uniform over the
    vertices with a live out-edge at the start.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Graph:
    src: torch.Tensor      # int32[C]
    dst: torch.Tensor      # int32[C]
    valid: torch.Tensor    # bool[C]
    num_vertices: int
    num_edges: int


@dataclasses.dataclass
class Feed:
    dels: np.ndarray       # int32[N, n_del, 2], host
    ins: np.ndarray        # int32[N, n_ins, 2], host

    @property
    def batches(self) -> int:
        return self.dels.shape[0]

    def kinds(self) -> np.ndarray:
        """Each batch's events in arrival order: deletions, insertions
        (1 = insertion)."""
        return np.concatenate([np.zeros(self.dels.shape[1], np.int64),
                               np.ones(self.ins.shape[1], np.int64)])

    def pairs(self, b: int):
        """(us, vs) of batch ``b`` in arrival order, as int64 arrays."""
        e = np.concatenate([self.dels[b], self.ins[b]]).astype(np.int64)
        return e[:, 0], e[:, 1]


@dataclasses.dataclass
class Queries:
    due_s: np.ndarray      # float64[M], seconds after the window opens
    vertex: np.ndarray     # int64[M]


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def rmat_graph(cfg: dict, gen: torch.Generator, device,
               min_free: int = 0) -> Graph:
    scale, ef = int(cfg["scale"]), int(cfg["edge_factor"])
    a, b, c = float(cfg["a"]), float(cfg["b"]), float(cfg["c"])
    n = 1 << scale
    m = ef * n
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for _ in range(scale):
        r = torch.rand(m, generator=gen, device=device)
        sb = r >= a + b
        db = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        src = (src << 1) | sb
        dst = (dst << 1) | db
    perm = torch.randperm(n, generator=gen, device=device)
    key = torch.unique(perm[src] * n + perm[dst])
    del perm
    del src, dst
    key = key[key // n != key % n]
    e = key.shape[0]
    cap = max(int(math.ceil(e * float(cfg["edge_capacity_factor"]))),
              e + int(min_free))
    s = torch.zeros(cap, dtype=torch.int32, device=device)
    d = torch.zeros(cap, dtype=torch.int32, device=device)
    v = torch.zeros(cap, dtype=torch.bool, device=device)
    s[:e] = (key // n).to(torch.int32)
    d[:e] = (key % n).to(torch.int32)
    v[:e] = True
    return Graph(s, d, v, n, e)


def feed(graph: Graph, mix: dict, batches: int,
         gen: torch.Generator) -> Feed:
    B = int(mix["batch_events"])
    n_ins = int(round(B * float(mix["insert_share"])))
    n_del = B - n_ins
    n, e = graph.num_vertices, graph.num_edges
    dev = graph.src.device
    if batches * n_del > e:
        raise ValueError(f"{batches} batches delete more edges than the "
                         f"graph's {e}")
    pick = torch.randperm(e, generator=gen, device=dev)[: batches * n_del]
    dels = torch.stack([graph.src[pick], graph.dst[pick]], 1)
    live = graph.src[:e].long() * n + graph.dst[:e].long()   # ascending
    want = batches * n_ins
    got = torch.empty(0, dtype=torch.int64, device=dev)
    while got.shape[0] < want:
        k = int((want - got.shape[0]) * 1.02) + 1024
        u = torch.randint(0, n, (k,), generator=gen, device=dev)
        w = torch.randint(0, n, (k,), generator=gen, device=dev)
        key = torch.cat([got, (u * n + w)[u != w]])
        pos = torch.searchsorted(live, key).clamp(max=e - 1)
        key = key[live[pos] != key]
        # the first of each repeated key, in draw order
        uniq, inv = torch.unique(key, return_inverse=True)
        first = torch.full((uniq.shape[0],), key.shape[0], dtype=torch.int64,
                           device=dev).scatter_reduce_(
            0, inv, torch.arange(key.shape[0], device=dev), "amin")
        got = key[torch.sort(first).values]
    got = got[:want]
    ins = torch.stack([got // n, got % n], 1).to(torch.int32)
    return Feed(dels.view(batches, n_del, 2).cpu().numpy(),
                ins.view(batches, n_ins, 2).cpu().numpy())


def queries(graph: Graph, spec: dict, horizon_s: float,
            gen: torch.Generator) -> Queries:
    rate = float(spec["rate_per_s"])
    dev = graph.src.device
    fixed = np.random.default_rng(int(spec["arrival_seed"]))
    count = int(rate * horizon_s * 1.1) + 64
    gaps = fixed.exponential(1.0 / rate, count)
    perm = torch.randperm(count, generator=gen, device=dev).cpu().numpy()
    due = np.cumsum(gaps[perm])
    deg = torch.bincount(graph.src[graph.valid].long(),
                         minlength=graph.num_vertices)
    pool = torch.nonzero(deg > 0).squeeze(1)
    pick = torch.randint(0, pool.shape[0], (count,), generator=gen,
                         device=dev)
    return Queries(due, pool[pick].cpu().numpy().astype(np.int64))


def warm_queries(graph: Graph, count: int, gen: Optional[torch.Generator]
                 ) -> np.ndarray:
    """Vertices for the warm-up queries (drawn after everything else)."""
    deg = torch.bincount(graph.src[graph.valid].long(),
                         minlength=graph.num_vertices)
    pool = torch.nonzero(deg > 0).squeeze(1)
    pick = torch.randint(0, pool.shape[0], (count,), generator=gen,
                         device=graph.src.device)
    return pool[pick].cpu().numpy().astype(np.int64)
