"""The f64 loop's fixed-order pull sum (``kernels.pull_contrib``, used by
``core.pagerank._contrib``) on the CPU.

Its contract: each vertex's segment of sorted slots is cut into chunks of
at most K slots (``PULL_CHUNK``, or ``chunk_slots``); each chunk's terms
R[u] * inv[u] are added one at a time, in slot order, from +0.0, then a
vertex's chunk sums are added to its first in chunk order.  The oracle
(``test_torch_common.chunked_sum``) is NumPy: ``np.add.at`` into one row
a chunk, then the rows of each vertex in order.  A segment of at most K
slots is one chunk: there the sum is also the old ``_contrib`` (one
``index_add_`` over every slot, dead slots adding +0.0) and ``np.add.at``
straight into the vertex, compared bit for bit.  Graphs: a hub, vertices
with no in-edges, dead and free slots, a graph with no live edge, and
segments of K - 1, K, K + 1, 2K + 1 and 0 slots.  The loop built on it is
compared bit for bit with the loop on the oracle's sum; its parity with
``repro`` is held by ``tests/test_torch_engine.py`` (L∞ ≤ 1e-12).  The
kernel itself needs the card (``tests/test_torch_cuda.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import pagerank as pr
from repro_torch.graph.dynamic import apply_batch, make_batch_update
from repro_torch.graph.generators import random_batch_update, rmat_edges
from repro_torch.graph.structure import from_coo
from repro_torch.kernels.pull_contrib import pull_contrib as pc
from repro_torch.kernels.pull_contrib.ref import PULL_CHUNK, \
    pull_contrib_ref, slot_vertex
from test_torch_common import CPU, chunked_sum


def _old_contrib(graph, ranks, inv):
    """The f64 pull sum before the fixed order: one ``index_add_`` over
    every slot, dead slots adding +0.0."""
    src = graph.src.long()
    w = torch.where(graph.valid, ranks[src] * inv[src],
                    torch.zeros((), dtype=ranks.dtype))
    out = torch.zeros(graph.num_vertices, dtype=ranks.dtype)
    return out.index_add_(0, graph.dst.long(), w)


def _live_terms(graph, ranks, inv):
    """(dst, term) of each live slot, in slot order."""
    src, dst = graph.src.numpy(), graph.dst.numpy()
    live = graph.valid.numpy()
    r, d = ranks.numpy(), inv.numpy()
    return dst[live], r[src[live]] * d[src[live]]


def _sequential(graph, ranks, inv):
    """np.add.at: each live slot's term added to its dst in slot order."""
    dst, terms = _live_terms(graph, ranks, inv)
    out = np.zeros(graph.num_vertices)
    np.add.at(out, dst, terms)
    return out


def _graph(kind):
    rng = np.random.default_rng(7)
    if kind == "hub":
        # vertex 3 gets ~5,000 in-edges among 2,000 random ones
        n = 6000
        src = np.concatenate([rng.permutation(n)[:5000],
                              rng.integers(0, n, 2000)])
        dst = np.concatenate([np.full(5000, 3), rng.integers(0, n, 2000)])
        keep = src != dst
        return from_coo(src[keep], dst[keep], n, device=CPU)
    if kind == "no_in_edges":
        # vertices 100.. have no in-edges, 0..99 no out-edges
        src = rng.integers(100, 400, 3000)
        dst = rng.integers(0, 100, 3000)
        return from_coo(src, dst, 400, device=CPU)
    if kind == "all_dead":
        g = from_coo(rng.integers(0, 50, 200), rng.integers(50, 100, 200),
                     100, device=CPU)
        return dataclasses.replace(g, valid=torch.zeros_like(g.valid))
    # dead and free slots: R-MAT after two batches of deletions and
    # insertions, in 1.5x capacity
    edges, n = rmat_edges(10, 8, seed=3)
    g = from_coo(edges[:, 0], edges[:, 1], n, device=CPU)
    for b in range(2):
        dele, ins = random_batch_update(edges, n, 200, seed=b)
        g = apply_batch(g, make_batch_update(dele, ins, 200, 200,
                                             device=CPU))
    return g


def _inputs(graph, seed=0):
    gen = torch.Generator().manual_seed(seed)
    ranks = torch.rand(graph.num_vertices, generator=gen,
                       dtype=torch.float64) / graph.num_vertices
    inv = 1.0 / graph.out_degree(include_self_loop=True).to(torch.float64)
    order = pc.pull_order(graph.src, graph.dst, graph.valid,
                          graph.num_vertices)
    return order, ranks, inv


@pytest.mark.parametrize("k", [4, PULL_CHUNK])
@pytest.mark.parametrize("kind", ["hub", "no_in_edges", "dead_and_free",
                                  "all_dead"])
def test_contrib_equals_old_index_add_bitwise(kind, k):
    """The chunked sum against the NumPy oracle on every vertex, and
    against the old ``index_add_`` form and ``np.add.at`` on every vertex
    of at most K in-edges (one chunk)."""
    g = _graph(kind)
    order, ranks, inv = _inputs(g)
    out = (pr._contrib(order, ranks, inv) if k == PULL_CHUNK
           else pc.pull_contrib(order, ranks, inv, chunk_slots=k))
    assert out.dtype == torch.float64 and out.shape == (g.num_vertices,)
    dst, terms = _live_terms(g, ranks, inv)
    np.testing.assert_array_equal(
        out.numpy(), chunked_sum(dst, terms, g.num_vertices, k))
    one_chunk = np.bincount(dst, minlength=g.num_vertices) <= k
    old = _old_contrib(g, ranks, inv)
    assert torch.equal(out[one_chunk], old[one_chunk])
    np.testing.assert_array_equal(out.numpy()[one_chunk],
                                  _sequential(g, ranks, inv)[one_chunk])
    if kind == "hub":
        assert int(order.ptr[4] - order.ptr[3]) >= 4999 > k
        assert not one_chunk[3]
    if kind == "no_in_edges":
        assert bool((out[100:] == 0).all()) and bool((out[:100] > 0).all())
    if kind == "dead_and_free":
        assert not bool(g.valid.all())
    if kind == "all_dead":
        assert bool((out == 0).all()) and int(order.ptr[-1]) == 0


_LENGTHS = {"K-1": lambda k: k - 1, "K": lambda k: k,
            "K+1": lambda k: k + 1, "2K+1": lambda k: 2 * k + 1,
            "0": lambda k: 0}


@pytest.mark.parametrize("k", [4, PULL_CHUNK])
@pytest.mark.parametrize("case", list(_LENGTHS))
def test_segment_lengths_around_k(k, case):
    """Vertex 3's segment holds K - 1, K, K + 1, 2K + 1 or no slots, among
    random edges: its sum is the oracle's; at most K slots, also the
    sequential sum (one chunk from +0.0)."""
    length = _LENGTHS[case](k)
    rng = np.random.default_rng(length)
    n = 2 * k + 40
    others = np.delete(np.arange(n), 3)         # no self-loop at 3
    src = np.concatenate([rng.permutation(others)[:length],
                          rng.integers(0, n, 3 * n)])
    dst = np.concatenate([np.full(length, 3), rng.integers(0, n, 3 * n)])
    keep = (src != dst) & ((dst != 3) | (np.arange(len(dst)) < length))
    g = from_coo(src[keep], dst[keep], n, dedup=False, device=CPU)
    order, ranks, inv = _inputs(g, seed=length)
    assert int(order.ptr[4] - order.ptr[3]) == length
    out = pc.pull_contrib(order, ranks, inv, chunk_slots=k)
    d, terms = _live_terms(g, ranks, inv)
    np.testing.assert_array_equal(out.numpy(), chunked_sum(d, terms, n, k))
    seq = _sequential(g, ranks, inv)
    if length <= k:
        assert out[3].item() == seq[3]
    if length == 0:
        assert out[3].item() == 0.0
    # chunk by chunk by hand: slot order within a chunk, then chunk order
    mine = terms[d == 3]
    want = None
    for c in range(0, length, k):
        part = 0.0
        for t in mine[c:c + k]:
            part = part + t
        want = part if want is None else want + part
    assert out[3].item() == (0.0 if want is None else want)


@pytest.mark.parametrize("kind", ["hub", "dead_and_free"])
def test_pull_order_is_a_stable_dst_sort(kind):
    g = _graph(kind)
    order, _, _ = _inputs(g)
    V, live = g.num_vertices, int(g.valid.sum())
    ptr = order.ptr.long()
    assert order.ptr.dtype == torch.int32 and ptr.shape == (V + 1,)
    assert int(ptr[0]) == 0 and int(ptr[-1]) == live
    assert bool((ptr[1:] >= ptr[:-1]).all())
    # live slots by dst, each dst's slots in slot order; dead ones last
    valid = g.valid.numpy()
    slots = np.flatnonzero(valid)
    want = slots[np.argsort(g.dst.numpy()[valid], kind="stable")]
    np.testing.assert_array_equal(order.src[:live].numpy(),
                                  g.src.numpy()[want])
    dst = slot_vertex(order.ptr, order.src.shape[0])
    np.testing.assert_array_equal(dst[:live].numpy(), g.dst.numpy()[want])
    assert bool((dst[live:] == V).all())


def test_wrapper_runs_plain_version_on_cpu():
    g = _graph("dead_and_free")
    order, ranks, inv = _inputs(g, seed=1)
    before = pc.LAUNCH_COUNTS["pull_contrib"]
    assert torch.equal(pc.pull_contrib(order, ranks, inv),
                       pull_contrib_ref(order, ranks, inv))
    assert pc.LAUNCH_COUNTS["pull_contrib"] == before
    # meta tensors run the launch path with no launch (the dry-run); a
    # mix of devices is refused
    m_order = type(order)(*(t.to("meta") for t in order))
    out = pc.pull_contrib(m_order, ranks.to("meta"), inv.to("meta"))
    assert (out.device.type, out.shape, out.dtype) == \
        ("meta", ranks.shape, torch.float64)
    assert pc.LAUNCH_COUNTS["pull_contrib"] == before
    with pytest.raises(ValueError, match="expected meta"):
        pc.pull_contrib(order, ranks.to("meta"), inv)


def _loop_run(method):
    """(run, g2): a solve on R-MAT after a batch, static or DF-P."""
    edges, n = rmat_edges(9, 8, seed=5)
    g = from_coo(edges[:, 0], edges[:, 1], n, device=CPU)
    dele, ins = random_batch_update(edges, n, 64, seed=2)
    upd = make_batch_update(dele, ins, 64, 64, device=CPU)
    g2 = apply_batch(g, upd)
    prev = pr.static_pagerank(g).ranks
    if method == "static":
        return (lambda: pr.static_pagerank(g2)), g2
    from repro_torch.graph.dynamic import touched_vertices_mask
    touched = touched_vertices_mask(upd, n)
    return (lambda: pr.dynamic_frontier_prune_pagerank(g, g2, touched,
                                                       prev)), g2


@pytest.mark.parametrize("k", [16, PULL_CHUNK])
@pytest.mark.parametrize("method", ["static", "frontier_prune"])
def test_pagerank_loop_equals_loop_on_old_sum(monkeypatch, method, k):
    """The loop's ranks, iterations and affected sets, bit for bit, with
    the fixed-order sum and with the NumPy oracle's sum in its place; at
    ``PULL_CHUNK`` no segment of this graph is split, and the loop also
    equals the loop on the old ``index_add_`` form."""
    run, g2 = _loop_run(method)
    if k != PULL_CHUNK:
        monkeypatch.setattr(pr, "_contrib", lambda order, r, inv:
                            pc.pull_contrib(order, r, inv, chunk_slots=k))
    new = run()

    def oracle(order, r, inv):
        dst, terms = _live_terms(g2, r, inv)
        return torch.from_numpy(chunked_sum(dst, terms, g2.num_vertices, k))
    monkeypatch.setattr(pr, "_contrib", oracle)
    ref = run()
    assert new.iterations == ref.iterations > 1
    assert torch.equal(new.ranks, ref.ranks)
    assert torch.equal(new.affected_ever, ref.affected_ever)
    assert new.host_syncs == new.iterations
    if k == PULL_CHUNK:
        assert int(g2.in_degree(include_self_loop=False).max()) <= k
        monkeypatch.setattr(pr, "_contrib",
                            lambda order, r, inv: _old_contrib(g2, r, inv))
        assert torch.equal(run().ranks, new.ranks)
    else:
        assert int(g2.in_degree(include_self_loop=False).max()) > k


@pytest.mark.parametrize("method", ["static", "frontier_prune"])
def test_pagerank_loop_is_bitwise_run_to_run(method):
    run, _ = _loop_run(method)
    a, b = run(), run()
    assert a.iterations == b.iterations
    assert torch.equal(a.ranks, b.ranks)
    assert torch.equal(a.affected_ever, b.affected_ever)
