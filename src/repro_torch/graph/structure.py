"""Capacity-padded edge-list graph (twin of ``repro.graph.structure``).

A graph is a *capacity padded edge list* so that one set of buffers
serves a whole update stream:

  * ``src``, ``dst``: int32[E_cap] endpoints (free and deleted slots carry
    ``valid = False``);
  * ``valid``: bool[E_cap] liveness — deletions flip it, insertions claim
    free slots;
  * degrees are derived from ``valid`` on demand, never stored stale.

A graph's counts by dst ride one dst-sorted slot order (``pull_order``:
one stable sort, whose keys give each vertex's segment through
``kernels.slot_count.segment_bounds``): ``in_degree`` is the segments'
lengths, ``push_or`` an OR over each segment (``segment_or``), ``push`` a
``kernels.pull_contrib`` sum over them (chunks of at most ``PULL_CHUNK``
slots, each in slot order from +0.0, then the chunks in order).  The
counts by src (``out_degree``) count live slots with
``kernels.slot_count``.  None issues an atomic by dst, and every sum here
is the same bit for bit from run to run.  The order and the out-degree
count are built once a graph and cached on its tensors (graphs are
frozen: ``apply_batch`` makes new ones); a cached value goes with the
tensors it was built from.

Every vertex carries an implicit **self-loop** (paper §3.1): out-degree is
``valid_out_degree + 1`` and the self contribution is folded into the rank
update, so no self-loop edges are materialised.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.pull_contrib.pull_contrib import PullOrder, \
    pull_contrib, pull_order
from repro_torch.kernels.segment_ops.plan import cached
from repro_torch.kernels.slot_count.slot_count import segment_or, slot_count

# builds of what is cached once a graph ("pull_order", "out_degree")
CACHE_BUILDS: collections.Counter = collections.Counter()


def _per_graph(tensors: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
               key: tuple, build: Callable[[], Any]) -> Any:
    """``build()`` at the first call on these (src, dst, valid) tensors
    with this ``key``, then handed back as is (``plan.cached``: the value
    goes when any of the tensors is freed); ``CACHE_BUILDS`` counts the
    builds."""
    def counted():
        value = build()
        CACHE_BUILDS[key[0]] += 1
        return value
    return cached(tensors, key, counted)


def cached_pull_order(src: torch.Tensor, dst: torch.Tensor,
                      valid: torch.Tensor, n: int) -> PullOrder:
    """``pull_order(src, dst, valid, n)``, built at the first call on these
    tensors and cached with them: a graph's solve, its frontier pushes and
    a GNN forward over its edge tensors share one sort."""
    return _per_graph((src, dst, valid), ("pull_order", n),
                      lambda: pull_order(src, dst, valid, n))


class CSRView(NamedTuple):
    """Compressed out-adjacency over the valid edges of an EdgeListGraph.

    ``deg`` excludes the implicit self-loop.
    """

    indptr: torch.Tensor    # int32[V + 1]
    indices: torch.Tensor   # int32[E_cap]  (valid prefix per segment only)
    deg: torch.Tensor       # int32[V]


@dataclasses.dataclass(frozen=True)
class EdgeListGraph:
    """Capacity-padded directed graph; all tensors on one device."""

    src: torch.Tensor          # int32[E_cap]
    dst: torch.Tensor          # int32[E_cap]
    valid: torch.Tensor        # bool[E_cap]
    num_vertices: int
    # number of slots ever claimed (live + dead)
    num_edges: Optional[torch.Tensor] = None   # int32[]

    @property
    def edge_capacity(self) -> int:
        return self.src.shape[0]

    @property
    def device(self) -> torch.device:
        return self.src.device

    # ---- derived quantities (masked by `valid`) --------------------------
    def pull_order(self) -> PullOrder:
        """The live slots sorted by dst (stable; dead slots last), built at
        the first call on this graph's tensors and cached with them."""
        return cached_pull_order(self.src, self.dst, self.valid,
                                 self.num_vertices)

    def out_degree(self, include_self_loop: bool = True) -> torch.Tensor:
        """int32[V] out-degree; +1 for the implicit self-loop.  The count
        is made once a graph (``slot_count`` by src) and cached."""
        V = self.num_vertices
        deg = _per_graph((self.src, self.dst, self.valid), ("out_degree", V),
                         lambda: slot_count(self.src, self.valid, V))
        return deg + 1 if include_self_loop else deg.clone()

    def in_degree(self, include_self_loop: bool = True) -> torch.Tensor:
        """int32[V] in-degree, the lengths of the pull order's segments;
        +1 for the implicit self-loop."""
        ptr = self.pull_order().ptr
        deg = ptr[1:] - ptr[:-1]
        return deg + 1 if include_self_loop else deg

    def num_valid_edges(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)

    # ---- message passing primitives --------------------------------------
    def push(self, values: torch.Tensor) -> torch.Tensor:
        """sum_{(u,v) in E} values[u] -> out[v] (f64 on the card), each
        vertex's terms summed in ``pull_contrib``'s fixed chunked order
        over its slots (one at a time from +0.0 for a vertex of at most
        ``PULL_CHUNK`` in-edges)."""
        return pull_contrib(self.pull_order(), values,
                            torch.ones_like(values))

    def push_or(self, flags: torch.Tensor) -> torch.Tensor:
        """Boolean frontier propagation: out[v] |= flags[u] for (u,v) in E,
        an OR over each vertex's segment of the pull order."""
        order = self.pull_order()
        return segment_or(order.ptr, order.src, order.dst, flags)

    def to_device_csr(self) -> CSRView:
        """CSR view over valid edges, neighbour order stable in slot order.

        ``indices[indptr[u] : indptr[u] + deg[u]]`` are u's out-neighbours;
        entries past ``indptr[V]`` are garbage and must never be read.
        """
        V = self.num_vertices
        key = torch.where(self.valid, self.src,
                          torch.full_like(self.src, V))
        order = torch.argsort(key, stable=True)
        deg = self.out_degree(include_self_loop=False)
        indptr = torch.cat([torch.zeros(1, dtype=torch.int32,
                                        device=deg.device),
                            torch.cumsum(deg, 0, dtype=torch.int32)])
        return CSRView(indptr=indptr, indices=self.dst[order], deg=deg)

    def to_host_csr(self):
        """NumPy CSR (indptr, indices) over valid edges."""
        src = self.src.cpu().numpy()
        dst = self.dst.cpu().numpy()
        valid = self.valid.cpu().numpy()
        s, d = src[valid], dst[valid]
        order = np.argsort(s, kind="stable")
        s, d = s[order], d[order]
        indptr = np.zeros(self.num_vertices + 1, dtype=np.int64)
        np.add.at(indptr, s + 1, 1)
        np.cumsum(indptr, out=indptr)
        return indptr, d


def sort_edges_by_dst(graph: EdgeListGraph) -> EdgeListGraph:
    """An equivalent graph whose slots are dst-sorted (invalid slots last)."""
    key = torch.where(graph.valid, graph.dst,
                      torch.full_like(graph.dst, graph.num_vertices))
    order = torch.argsort(key, stable=True)
    return dataclasses.replace(
        graph, src=graph.src[order], dst=graph.dst[order],
        valid=graph.valid[order])


def unique_edges(src: np.ndarray, dst: np.ndarray, num_vertices: int):
    """Sorted unique (src, dst) pairs; the same set and order as
    ``np.unique(np.stack([src, dst], 1), axis=0)``, via a 1-D int64 key
    (much faster at tens of millions of edges)."""
    key = np.unique(src.astype(np.int64) * num_vertices + dst)
    return ((key // num_vertices).astype(np.int32),
            (key % num_vertices).astype(np.int32))


def from_coo(src: np.ndarray, dst: np.ndarray, num_vertices: int,
             edge_capacity: Optional[int] = None,
             dedup: bool = True, device: DeviceLike = None) -> EdgeListGraph:
    """Build a graph from host COO arrays (deduplicated, capacity padded)."""
    device = resolve_device(device)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    if dedup and len(src):
        src, dst = unique_edges(src, dst, int(num_vertices))
    e = len(src)
    if edge_capacity is None:
        edge_capacity = max(16, int(e * 1.5))
    if e > edge_capacity:
        raise ValueError(f"{e} edges exceed capacity {edge_capacity}")
    pad = edge_capacity - e
    as_t = lambda a: torch.from_numpy(a).to(device)
    return EdgeListGraph(
        src=as_t(np.concatenate([src, np.zeros(pad, np.int32)])),
        dst=as_t(np.concatenate([dst, np.zeros(pad, np.int32)])),
        valid=as_t(np.concatenate([np.ones(e, bool), np.zeros(pad, bool)])),
        num_vertices=int(num_vertices),
        num_edges=torch.tensor(e, dtype=torch.int32, device=device),
    )
