"""The counts by dst over the dst-sorted slot order, on the CPU.

A graph's in-degrees are the segment lengths of its pull order (``ptr``,
written from the sort's keys by ``kernels.slot_count.segment_bounds``)
and ``push_or`` is an OR over each segment (``segment_or``); the order
and the out-degree count are built once a graph and cached on its
tensors.  Held here, bit for bit:

  * ``segment_bounds``' plain version against the cumsum of the atomic
    count (``slot_count_ref``) and, through ``in_degree``, against
    ``repro``'s ``in_degree``;
  * the order's permutation (``torch.sort(stable=True)``) against the old
    ``torch.argsort(stable=True)``, on which every fixed-order f64 sum
    rests;
  * ``push_or`` through the order against ``repro``'s ``push_or`` and
    the old route (``slot_count_ref(...) > 0``) at frontier fractions 0,
    1 %, 50 % and 100 %;
  * on a hub, vertices with no in-edge (vertex 0 and the last ones), a
    graph with no live slot, and a graph whose every slot is live;
  * over an ``apply_batch`` stream: one order a graph, shared by
    ``in_degree``, ``push_or`` and ``push``; the cache goes with the
    graph, and a graph built after a freed one gets a fresh order.

The kernels themselves need the card (``tests/test_torch_cuda.py``).
"""
import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax.numpy as jnp
from repro.core import pagerank as jpr
from repro.graph import dynamic as jdyn
from repro.graph import generators as jgen
from repro.graph import structure as jstr

from repro_torch.core import pagerank as tpr
from repro_torch.graph import dynamic as tdyn
from repro_torch.graph import structure as tstr
from repro_torch.kernels.pull_contrib import pull_contrib as pc
from repro_torch.kernels.segment_ops import plan as tplan
from repro_torch.kernels.slot_count import slot_count as sc
from repro_torch.kernels.slot_count.ref import segment_bounds_ref, \
    segment_or_ref, slot_count_ref
from test_torch_common import CPU, assert_bitwise, np_, port_graph

KINDS = ["rmat", "hub", "no_live", "full", "gaps"]


def _ref_graph(kind):
    """A reference graph of a few hundred vertices: R-MAT with dead and
    free slots (``rmat``), one hub of 300 in-edges (``hub``), no live slot
    (``no_live``), every slot live (``full``), or in-edges only to
    vertices 1 .. n - 41, so vertex 0 and the last 40 have none
    (``gaps``)."""
    rng = np.random.default_rng(31)
    if kind == "hub":
        n = 400
        src = np.concatenate([rng.permutation(n)[:300],
                              rng.integers(0, n, 500)])
        dst = np.concatenate([np.full(300, 17), rng.integers(0, n, 500)])
        keep = src != dst
        return jstr.from_coo(src[keep], dst[keep], n)
    if kind == "gaps":
        n = 301
        return jstr.from_coo(rng.integers(0, n, 1500),
                             rng.integers(1, n - 40, 1500), n)
    edges, n = jgen.rmat_edges(8, 6, seed=2)
    if kind == "full":
        return jstr.from_coo(edges[:, 0], edges[:, 1], n,
                             edge_capacity=len(edges))
    g = jstr.from_coo(edges[:, 0], edges[:, 1], n)
    keep = (jnp.zeros(g.edge_capacity, bool) if kind == "no_live"
            else jnp.asarray(rng.random(g.edge_capacity) < 0.8))
    return dataclasses.replace(g, valid=g.valid & keep)


def _keys(tg):
    V = tg.num_vertices
    return torch.where(tg.valid, tg.dst, torch.full_like(tg.dst, V))


@pytest.mark.parametrize("kind", KINDS)
def test_segment_bounds_equals_cumsum_and_reference_in_degree(kind):
    jg = _ref_graph(kind)
    tg = port_graph(jg)
    V = tg.num_vertices
    keys = torch.sort(_keys(tg), stable=True).values
    ptr = sc.segment_bounds(keys, V)
    assert ptr.dtype == torch.int32 and ptr.shape == (V + 1,)
    counts = slot_count_ref(tg.dst, tg.valid, V)
    want = torch.cat([torch.zeros(1, dtype=torch.int64),
                      torch.cumsum(counts.long(), 0)]).to(torch.int32)
    assert_bitwise(ptr, want, kind)
    assert_bitwise(ptr[1:] - ptr[:-1], jg.in_degree(False), kind)
    for loop in (True, False):
        assert_bitwise(tg.in_degree(loop), jg.in_degree(loop), kind)
        assert_bitwise(tg.out_degree(loop), jg.out_degree(loop), kind)
    assert int(ptr[V]) == int(tg.valid.sum())
    if kind == "gaps":
        assert int(ptr[1]) == 0 and int(ptr[V - 40]) == int(ptr[V])
    if kind == "no_live":
        assert not bool(ptr.any())


@pytest.mark.parametrize("kind", KINDS)
def test_order_perm_equals_old_argsort(kind):
    tg = port_graph(_ref_graph(kind))
    V = tg.num_vertices
    old = torch.argsort(_keys(tg), stable=True)
    ptr, perm, keys = pc.sorted_slots(tg.dst, tg.valid, V)
    assert perm.dtype == torch.int64 and torch.equal(perm, old)
    assert torch.equal(keys, _keys(tg)[old])
    order = pc.pull_order(tg.src, tg.dst, tg.valid, V)
    assert torch.equal(order.src, tg.src[old])
    assert torch.equal(order.dst, keys) and torch.equal(order.ptr, ptr)
    assert torch.equal(tg.pull_order().src, order.src)


@pytest.mark.parametrize("frac", [0.0, 0.01, 0.5, 1.0])
@pytest.mark.parametrize("kind", KINDS)
def test_push_or_through_order_equals_reference(kind, frac):
    jg = _ref_graph(kind)
    tg = port_graph(jg)
    V = tg.num_vertices
    flags = np.random.default_rng(int(frac * 100)).random(V) < frac
    f = torch.from_numpy(flags)
    order = tg.pull_order()
    got = sc.segment_or(order.ptr, order.src, order.dst, f)
    assert got.dtype == torch.bool
    assert_bitwise(got, jg.push_or(jnp.asarray(flags)), (kind, frac))
    assert torch.equal(tg.push_or(f), got)
    # the old route: the gathered atomic count by dst
    assert torch.equal(got, slot_count_ref(tg.dst, tg.valid, V, tg.src, f)
                       > 0)
    assert torch.equal(got, segment_or_ref(order.ptr, order.src, order.dst,
                                           f))
    if frac == 0.0 or kind == "no_live":
        assert not bool(got.any())


def test_segment_kernels_edge_cases():
    # no slot at all, and keys all dead
    empty = torch.zeros(0, dtype=torch.int32)
    assert_bitwise(sc.segment_bounds(empty, 5), np.zeros(6, np.int32))
    dead = torch.full((7,), 5, dtype=torch.int32)
    assert_bitwise(sc.segment_bounds(dead, 5), np.zeros(6, np.int32))
    # every key live, the last below V - 1: the end fills the rest
    keys = torch.tensor([0, 0, 2, 2, 2, 3], dtype=torch.int32)
    assert_bitwise(sc.segment_bounds(keys, 6),
                   np.array([0, 2, 2, 5, 6, 6, 6], np.int32))
    ptr = sc.segment_bounds(keys, 6)
    src = torch.tensor([4, 1, 0, 5, 2, 3], dtype=torch.int32)
    flags = torch.tensor([False, True, False, False, False, True])
    assert_bitwise(sc.segment_or(ptr, src, keys, flags),
                   np.array([True, False, True, False, False, False]))
    assert_bitwise(sc.segment_or(ptr, src, keys, torch.ones(6, dtype=bool)),
                   np.array([True, False, True, True, False, False]))
    # a dead slot's flag is never read into the OR
    ptr_dead = torch.tensor([0, 2, 2, 2, 2, 2, 2], dtype=torch.int32)
    assert_bitwise(sc.segment_or(ptr_dead, src, keys, flags),
                   np.array([True, False, False, False, False, False]))
    # meta tensors run the launch path with no launch (the dry-run); a
    # mix of devices is refused
    before = dict(sc.LAUNCH_COUNTS)
    m_ptr = sc.segment_bounds(keys.to("meta"), 6)
    assert (m_ptr.device.type, m_ptr.shape, m_ptr.dtype) == \
        ("meta", ptr.shape, ptr.dtype)
    m_or = sc.segment_or(m_ptr, src.to("meta"), keys.to("meta"),
                         flags.to("meta"))
    assert (m_or.device.type, m_or.shape, m_or.dtype) == \
        ("meta", (6,), torch.bool)
    assert dict(sc.LAUNCH_COUNTS) == before
    with pytest.raises(ValueError, match="is on cpu, expected meta"):
        sc.segment_or(ptr, src.to("meta"), keys, flags)


def _stream(steps=4):
    """A seeded R-MAT stream as both packages build it."""
    edges, n, batches = jgen.update_stream(
        7, 4, regime="mixed", graph="rmat", num_batches=steps,
        batch_size=24, seed=13)
    jg = jstr.from_coo(edges[:, 0], edges[:, 1], n,
                       edge_capacity=len(edges) + 96)
    return jg, port_graph(jg), batches


def test_one_order_a_graph_over_a_stream():
    jg, tg, batches = _stream()
    rng = np.random.default_rng(3)
    n = tg.num_vertices
    for step, (dels, ins) in enumerate(batches):
        ju = jdyn.make_batch_update(dels, ins, 32, 32)
        tu = tdyn.make_batch_update(dels, ins, 32, 32, device=CPU)
        jg2, tg2 = jdyn.apply_batch(jg, ju), tdyn.apply_batch(tg, tu)
        before = dict(tstr.CACHE_BUILDS)
        flags = rng.random(n) < 0.3
        vals = rng.random(n)
        for _ in range(2):
            assert_bitwise(tg2.in_degree(False), jg2.in_degree(False), step)
            assert_bitwise(tg2.push_or(torch.from_numpy(flags)),
                           jg2.push_or(jnp.asarray(flags)), step)
            np.testing.assert_allclose(
                np_(tg2.push(torch.from_numpy(vals))),
                np.asarray(jg2.push(jnp.asarray(vals))), rtol=1e-12,
                atol=0)
            assert_bitwise(tg2.out_degree(), jg2.out_degree(), step)
            tg2.to_device_csr()
        # the previous graph's order is still the one it built
        touched_t = tdyn.touched_vertices_mask(tu, n)
        assert_bitwise(tpr.initial_affected(tg, tg2, touched_t),
                       jpr.initial_affected(
                           jg, jg2, jdyn.touched_vertices_mask(ju, n)),
                       step)
        built = {k: tstr.CACHE_BUILDS[k] - before.get(k, 0)
                 for k in ("pull_order", "out_degree")}
        # tg's order was built in the previous step (or now, at step 0)
        assert built == {"pull_order": 1 + (step == 0), "out_degree": 1}, \
            (step, built)
        jg, tg = jg2, tg2
    # the cache goes with the graph's tensors
    order = weakref.ref(tg.pull_order().src)
    slot = (id(tg.src), id(tg.dst), id(tg.valid))
    assert slot in tplan._PLANS
    del tg, tg2
    gc.collect()
    assert order() is None and slot not in tplan._PLANS


def test_graph_after_a_freed_one_gets_a_fresh_order():
    """A graph built where a freed one lived (its tensors' ids may be
    reused) gets its own order, never the freed graph's."""
    rng = np.random.default_rng(8)
    for trial in range(4):
        n = 200
        g = tstr.from_coo(rng.integers(0, n, 900), rng.integers(0, n, 900),
                          n, edge_capacity=1200, dedup=False, device=CPU)
        order = g.pull_order()
        fresh = pc.pull_order(g.src, g.dst, g.valid, n)
        assert torch.equal(order.ptr, fresh.ptr)
        assert torch.equal(order.src, fresh.src)
        assert torch.equal(g.in_degree(False),
                           slot_count_ref(g.dst, g.valid, n))
        del g, order
        gc.collect()


@pytest.mark.parametrize("dropped", [0, 1, 2])
def test_cache_on_tensors_goes_with_any_of_them(dropped):
    """``plan.cached`` on a tuple of tensors (a graph's src, dst, valid):
    one value for the tuple, built once; freeing any one of the tensors
    drops it, and a new tuple gets a value of its own."""
    ts = [torch.arange(5, dtype=torch.int32) + i for i in range(3)]
    slot = tuple(id(t) for t in ts)
    built = []
    first = tplan.cached(tuple(ts), "k", lambda: built.append(1) or [1])
    assert tplan.cached(tuple(ts), "k", lambda: [2]) is first
    assert tplan.cached(tuple(ts[:2]), "k", lambda: [3]) == [3]
    assert len(built) == 1 and slot in tplan._PLANS
    del ts[dropped]
    gc.collect()
    assert slot not in tplan._PLANS
    ts.insert(dropped, torch.zeros(5, dtype=torch.int32))
    assert tplan.cached(tuple(ts), "k", lambda: [4]) == [4]


def test_a_solve_counts_nothing_by_dst(monkeypatch):
    """The f64 loop and DF-P's initial marking count only by src
    (``slot_count`` on ``out_degree``'s call, once a graph), sort each
    graph once and OR every frontier push over the order."""
    jg, tg, batches = _stream(steps=1)
    n = tg.num_vertices
    dels, ins = batches[0]
    tu = tdyn.make_batch_update(dels, ins, 32, 32, device=CPU)
    tg2 = tdyn.apply_batch(tg, tu)
    counted, ors = [], []
    real_count, real_or = tstr.slot_count, tstr.segment_or

    def count(index, *a, **kw):
        counted.append(index)
        return real_count(index, *a, **kw)

    def seg_or(*a):
        ors.append(a[0])
        return real_or(*a)
    monkeypatch.setattr(tstr, "slot_count", count)
    monkeypatch.setattr(tstr, "segment_or", seg_or)
    before = dict(tstr.CACHE_BUILDS)
    prev = tpr.static_pagerank(tg).ranks
    res = tpr.dynamic_frontier_prune_pagerank(
        tg, tg2, tdyn.touched_vertices_mask(tu, n), prev)
    assert res.iterations > 1
    assert all(t is tg.src or t is tg2.src for t in counted)
    assert len(counted) == 2              # an out-degree count a graph
    assert len(ors) >= 2 + (res.iterations - 1)
    assert {tstr.CACHE_BUILDS[k] - before.get(k, 0)
            for k in ("pull_order", "out_degree")} == {2}


def test_gnn_forward_shares_the_graph_order():
    """A forward over a graph's own edge tensors takes the order its
    ``push_or`` built (one sort a batch), and sums the same."""
    from repro_torch.models import gnn as tgnn
    _, tg, _ = _stream(steps=1)
    n = tg.num_vertices
    cfg = tgnn.SAGEConfig(d_in=6, d_hidden=5, n_classes=3)
    params = tgnn.init_sage(cfg, torch.Generator().manual_seed(2))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (n, cfg.d_in)).astype(np.float32))
    every = torch.ones(n, dtype=torch.bool)
    tg.push_or(every)
    before = tstr.CACHE_BUILDS["pull_order"]
    out = tgnn.sage_forward(cfg, params, tgnn.GraphBatch(
        x, tg.src, tg.dst, tg.valid, every))
    assert tstr.CACHE_BUILDS["pull_order"] == before
    # the same sums as a forward over copies of the tensors (a new sort)
    fresh = tgnn.sage_forward(cfg, params, tgnn.GraphBatch(
        x, tg.src.clone(), tg.dst.clone(), tg.valid.clone(), every))
    assert tstr.CACHE_BUILDS["pull_order"] == before + 1
    assert torch.equal(out, fresh)
