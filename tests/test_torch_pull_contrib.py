"""The f64 loop's fixed-order pull sum (``kernels.pull_contrib``, used by
``core.pagerank._contrib``) on the CPU.

Its contract: each vertex's in-edge terms R[u] * inv[u] are added one at
a time, in slot order, from +0.0.  That is what the old ``_contrib``
(one ``index_add_`` over every slot, dead slots adding +0.0) computes on
the CPU and what ``np.add.at`` computes, so all three are compared bit
for bit: with a hub, vertices with no in-edges, dead and free slots, and
a graph with no live edge.  The loop built on it is compared bit for bit
with the loop on the old sum; its parity with ``repro`` is held by
``tests/test_torch_engine.py`` (L∞ ≤ 1e-12).  The kernel itself needs the
card (``tests/test_torch_cuda.py``).
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
from repro_torch.kernels.pull_contrib.ref import pull_contrib_ref, \
    slot_vertex
from test_torch_common import CPU


def _old_contrib(graph, ranks, inv):
    """The f64 pull sum before the fixed order: one ``index_add_`` over
    every slot, dead slots adding +0.0."""
    src = graph.src.long()
    w = torch.where(graph.valid, ranks[src] * inv[src],
                    torch.zeros((), dtype=ranks.dtype))
    out = torch.zeros(graph.num_vertices, dtype=ranks.dtype)
    return out.index_add_(0, graph.dst.long(), w)


def _sequential(graph, ranks, inv):
    """np.add.at: each live slot's term added to its dst in slot order."""
    src, dst = graph.src.numpy(), graph.dst.numpy()
    live = graph.valid.numpy()
    r, d = ranks.numpy(), inv.numpy()
    out = np.zeros(graph.num_vertices)
    np.add.at(out, dst[live], r[src[live]] * d[src[live]])
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
                          graph.in_degree(include_self_loop=False))
    return order, ranks, inv


@pytest.mark.parametrize("kind", ["hub", "no_in_edges", "dead_and_free",
                                  "all_dead"])
def test_contrib_equals_old_index_add_bitwise(kind):
    g = _graph(kind)
    order, ranks, inv = _inputs(g)
    out = pr._contrib(order, ranks, inv)
    old = _old_contrib(g, ranks, inv)
    assert out.dtype == torch.float64 and out.shape == (g.num_vertices,)
    assert torch.equal(out, old)
    np.testing.assert_array_equal(out.numpy(), _sequential(g, ranks, inv))
    if kind == "hub":
        assert int(order.ptr[4] - order.ptr[3]) >= 4999
    if kind == "no_in_edges":
        assert bool((out[100:] == 0).all()) and bool((out[:100] > 0).all())
    if kind == "dead_and_free":
        assert not bool(g.valid.all())
    if kind == "all_dead":
        assert bool((out == 0).all()) and int(order.ptr[-1]) == 0


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
    with pytest.raises(ValueError, match="no kernel for device meta"):
        pc.pull_contrib(order, ranks.to("meta"), inv)


@pytest.mark.parametrize("method", ["static", "frontier_prune"])
def test_pagerank_loop_equals_loop_on_old_sum(monkeypatch, method):
    """The loop's ranks, iterations and affected sets, bit for bit, with
    the fixed-order sum and with the old ``index_add_`` form."""
    edges, n = rmat_edges(9, 8, seed=5)
    g = from_coo(edges[:, 0], edges[:, 1], n, device=CPU)
    dele, ins = random_batch_update(edges, n, 64, seed=2)
    upd = make_batch_update(dele, ins, 64, 64, device=CPU)
    g2 = apply_batch(g, upd)
    prev = pr.static_pagerank(g).ranks
    if method == "static":
        run = lambda: pr.static_pagerank(g2)
    else:
        from repro_torch.graph.dynamic import touched_vertices_mask
        touched = touched_vertices_mask(upd, n)
        run = lambda: pr.dynamic_frontier_prune_pagerank(g, g2, touched,
                                                         prev)
    new = run()
    monkeypatch.setattr(pr, "_contrib",
                        lambda order, r, inv: _old_contrib(g2, r, inv))
    old = run()
    assert new.iterations == old.iterations > 1
    assert torch.equal(new.ranks, old.ranks)
    assert torch.equal(new.affected_ever, old.affected_ever)
    assert new.host_syncs == new.iterations
