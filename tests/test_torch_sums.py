"""The port's counts and sums without float atomics, on the CPU.

  * ``kernels.slot_count`` (the degrees and ``push_or``): against
    ``np.bincount`` and, through ``EdgeListGraph``, against ``repro`` bit
    for bit: on R-MAT with dead and free slots, on a graph of only free
    slots, and on a one-hub graph.
  * The weighted ``pull_contrib``: each vertex's terms (r[u] * w) * inv[u]
    in chunks of at most K slots, each added in slot order from +0.0, then
    the chunks in order, compared bit for bit with the NumPy oracle
    (``test_torch_common.chunked_sum``: ``np.add.at`` a chunk, then chunk
    order) and, on segments of at most K slots, with ``np.add.at``
    straight into the vertex; so are ``pull_values`` (values of any
    length) and ``segment_sum``, each also through a split hub (K = 4).
  * Each f64 site routed through it (the personalized and weighted solves,
    PPR visit counts and seed masses, ``push``) against its old
    ``index_add_`` form on the CPU, bit for bit; its parity with
    ``repro`` is held by ``tests/test_torch_ppr.py`` and
    ``tests/test_torch_graph.py`` (and below for the solves, L∞ ≤ 1e-12).
  * ``pull_rows`` (GraphSAGE's neighbour sums): chunks of K slots summed
    in slot order, then in chunk order, against a NumPy loop bit for
    bit; against the old ``index_add_`` form bit for bit when no vertex
    is split, and within the GNN tests' tolerance when one is.

The kernels themselves need the card (``tests/test_torch_cuda.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax.numpy as jnp
from repro.core import extensions as jext
from repro.graph import generators as jgen
from repro.graph import structure as jstr

from repro_torch.core import extensions as text
from repro_torch.graph.dynamic import apply_batch, make_batch_update, \
    touched_vertices_mask
from repro_torch.graph.generators import random_batch_update, rmat_edges
from repro_torch.graph.structure import from_coo
from repro_torch.kernels.pull_contrib import pull_contrib as pc
from repro_torch.kernels.pull_contrib.ref import PULL_CHUNK, \
    pull_contrib_ref, pull_rows_ref, slot_vertex
from repro_torch.kernels.slot_count.slot_count import slot_count
from repro_torch.models import gnn as tgnn
from repro_torch.ppr import IndexConfig, build_walk_index
from repro_torch.ppr import query as tquery
from test_torch_common import CPU, assert_bitwise, chunked_sum, np_, \
    port_graph


# ---------------------------------------------------------------------------
# slot_count: degrees and push_or
# ---------------------------------------------------------------------------

def _ref_graph(kind):
    """A reference graph: R-MAT with dead and free slots (``rmat``), only
    free slots (``all_free``), or one hub among random edges (``hub``)."""
    rng = np.random.default_rng(5)
    if kind == "all_free":
        e = np.zeros((0, 2), np.int32)
        return jstr.from_coo(e[:, 0], e[:, 1], 64, edge_capacity=200)
    if kind == "hub":
        n = 3000
        src = np.concatenate([rng.permutation(n)[:2500],
                              np.full(700, 11), rng.integers(0, n, 1500)])
        dst = np.concatenate([np.full(2500, 11), rng.permutation(n)[:700],
                              rng.integers(0, n, 1500)])
        keep = src != dst
        return jstr.from_coo(src[keep], dst[keep], n)
    edges, n = jgen.rmat_edges(9, 8, seed=4)
    g = jstr.from_coo(edges[:, 0], edges[:, 1], n)
    return dataclasses.replace(g, valid=g.valid & jnp.asarray(
        rng.random(g.edge_capacity) < 0.8))


@pytest.mark.parametrize("kind", ["rmat", "all_free", "hub"])
def test_degrees_and_push_or_match_reference(kind):
    jg = _ref_graph(kind)
    tg = port_graph(jg)
    for loop in (True, False):
        assert_bitwise(tg.out_degree(loop), jg.out_degree(loop), kind)
        assert_bitwise(tg.in_degree(loop), jg.in_degree(loop), kind)
    rng = np.random.default_rng(1)
    for frac in (0.0, 0.01, 0.3, 1.0):
        flags = rng.random(jg.num_vertices) < frac
        assert_bitwise(tg.push_or(torch.from_numpy(flags)),
                       jg.push_or(jnp.asarray(flags)), (kind, frac))


@pytest.mark.parametrize("kind", ["rmat", "all_free", "hub"])
def test_slot_count_equals_bincount(kind):
    tg = port_graph(_ref_graph(kind))
    n = tg.num_vertices
    src, dst, live = np_(tg.src), np_(tg.dst), np_(tg.valid)
    want = np.bincount(dst[live], minlength=n)
    assert_bitwise(slot_count(tg.dst, tg.valid, n), want.astype(np.int32))
    flags = np.random.default_rng(2).random(n) < 0.2
    hit = live & flags[src]
    got = slot_count(tg.dst, tg.valid, n, tg.src, torch.from_numpy(flags))
    assert_bitwise(got, np.bincount(dst[hit], minlength=n).astype(np.int32))
    with pytest.raises(ValueError, match="go together"):
        slot_count(tg.dst, tg.valid, n, tg.src)


# ---------------------------------------------------------------------------
# the weighted pull sum and the f64 sites routed through it
# ---------------------------------------------------------------------------

def _stream_graph():
    """R-MAT after a batch of deletions and insertions (dead and free
    slots), its predecessor, the batch's touched mask and edge weights."""
    edges, n = rmat_edges(9, 8, seed=3)
    g = from_coo(edges[:, 0], edges[:, 1], n, device=CPU)
    dele, ins = random_batch_update(edges, n, 128, seed=1)
    upd = make_batch_update(dele, ins, 128, 128, device=CPU)
    g2 = apply_batch(g, upd)
    w = torch.from_numpy(np.random.default_rng(4).random(g.edge_capacity)
                         + 0.5)
    return g, g2, touched_vertices_mask(upd, n), w


@pytest.mark.parametrize("k", [4, PULL_CHUNK])
def test_weighted_pull_contrib_ref_equals_sequential_sum(k):
    _, g, _, w = _stream_graph()
    n = g.num_vertices
    rng = np.random.default_rng(9)
    ranks = torch.from_numpy(rng.random(n) / n)
    inv = 1.0 / g.out_degree(include_self_loop=True).to(torch.float64)
    ptr, perm, _ = pc.sorted_slots(g.dst, g.valid, n)
    order = pc.PullOrder(ptr, g.src[perm])
    out = pc.pull_contrib(order, ranks, inv, w[perm], chunk_slots=k)
    src, dst, live = np_(g.src), np_(g.dst), np_(g.valid)
    r, d, ww = np_(ranks), np_(inv), np_(w)
    terms = r[src[live]] * ww[live] * d[src[live]]
    # the chunked order: np.add.at a chunk, then the chunks in order
    assert_bitwise(out, chunked_sum(dst[live], terms, n, k))
    # np.add.at adds each live slot's term to its dst in slot order: the
    # same sum on every segment of at most K slots
    one_chunk = np.bincount(dst[live], minlength=n) <= k
    want = np.zeros(n)
    np.add.at(want, dst[live], terms)
    assert_bitwise(np_(out)[one_chunk], want[one_chunk])
    assert bool(one_chunk.all()) == (k == PULL_CHUNK)
    # and index_add_ of the same products over the sorted slots
    s = order.src.long()
    prod = ranks[s] * w[perm] * inv[s]
    again = torch.zeros(n + 1, dtype=torch.float64).index_add_(
        0, slot_vertex(ptr, s.shape[0]), prod)[:n]
    assert torch.equal(out[torch.from_numpy(one_chunk)],
                       again[torch.from_numpy(one_chunk)])
    # weight 1 is the unweighted sum, bit for bit
    assert torch.equal(pull_contrib_ref(order, ranks, inv, chunk_slots=k),
                       pc.pull_contrib(order, ranks, inv,
                                       torch.ones_like(w), chunk_slots=k))


@pytest.mark.parametrize("k", [4, PULL_CHUNK])
@pytest.mark.parametrize("rows", [1, 3])
def test_pull_values_and_segment_sum_equal_sequential_sums(rows, k):
    """Values shorter than V, ``rows`` positions a value (the PPR visit
    counts' keyed sum), and the segment sum, with a hub of 150 keys: the
    NumPy oracle's chunked order, and where a segment is one chunk the
    sequential sum ``np.add.at`` computes."""
    n, m = 40, 600
    rng = np.random.default_rng(rows)
    keys = rng.integers(-1, n, m).astype(np.int32)
    keys[:150] = 5                                  # a hub of keys
    values = rng.random(m // rows + 1)
    w = rng.random(m) + 0.5
    k_ = torch.from_numpy(keys)
    live = k_ >= 0
    ptr, perm, _ = pc.sorted_slots(k_, live, n)
    order = pc.PullOrder(ptr, torch.div(perm, rows, rounding_mode="floor")
                         .to(torch.int32))
    pos, kl = np.nonzero(keys >= 0)[0], keys[keys >= 0]
    one_chunk = np.bincount(kl, minlength=n) <= k
    assert bool(one_chunk[5]) == (k == PULL_CHUNK)
    for weight, want_terms in ((None, values[pos // rows]),
                               (w, values[pos // rows] * w[pos])):
        out = pc.pull_values(order, torch.from_numpy(values),
                             None if weight is None
                             else torch.from_numpy(weight)[perm],
                             chunk_slots=k)
        assert out.shape == (n,)
        assert_bitwise(out, chunked_sum(kl, want_terms, n, k))
        want = np.zeros(n)
        np.add.at(want, kl, want_terms)
        assert_bitwise(np_(out)[one_chunk], want[one_chunk])
    out = pc.segment_sum(ptr, torch.from_numpy(w)[perm], chunk_slots=k)
    assert_bitwise(out, chunked_sum(kl, w[pos], n, k))
    want = np.zeros(n)
    np.add.at(want, kl, w[pos])
    assert_bitwise(np_(out)[one_chunk], want[one_chunk])


def _old_extension_sums(graph, edge_weight):
    """The weighted out-degree and the pull sum of ``core.extensions``
    before the fixed order: ``index_add_`` over every slot, dead slots
    adding +0.0."""
    src, dst = graph.src.long(), graph.dst.long()
    zero = torch.zeros((), dtype=torch.float64)
    V = graph.num_vertices
    cw = (torch.ones(graph.edge_capacity, dtype=torch.float64)
          if edge_weight is None else edge_weight)

    def contrib(order, ranks, inv_w, slot_w):
        vals = torch.where(graph.valid, ranks[src] * cw * inv_w[src], zero)
        return torch.zeros(V, dtype=torch.float64).index_add_(0, dst, vals)

    def w_out(ptr, w):
        return torch.zeros(V, dtype=torch.float64).index_add_(
            0, src, torch.where(graph.valid, edge_weight, zero))
    return contrib, w_out


@pytest.mark.parametrize("solve", ["personalized", "weighted"])
@pytest.mark.parametrize("warm", [False, True])
def test_extension_solves_equal_old_index_add_form(solve, warm,
                                                   monkeypatch):
    g, g2, touched, w = _stream_graph()
    mask = torch.zeros(g.num_vertices, dtype=torch.bool)
    mask[[5, 40, 41]] = True
    fn = text.personalized_pagerank if solve == "personalized" \
        else text.weighted_pagerank
    arg = mask if solve == "personalized" else w
    prev = fn(g, arg).ranks

    def run():
        return fn(g2, arg, prev, g, touched) if warm else fn(g2, arg)
    new = run()
    contrib, w_out = _old_extension_sums(
        g2, None if solve == "personalized" else w)
    monkeypatch.setattr(text, "pull_contrib", contrib)
    monkeypatch.setattr(text, "segment_sum", w_out)
    old = run()
    assert new.iterations == old.iterations > 1
    assert torch.equal(new.ranks, old.ranks)
    assert torch.equal(new.affected_ever, old.affected_ever)


def test_weighted_solve_matches_reference_after_a_batch():
    """The weighted solve on a graph with dead and free slots, warm and
    cold, against ``repro`` (the port's f64 contract, L∞ ≤ 1e-12)."""
    edges, n = jgen.rmat_edges(8, 8, seed=2)
    jg = jstr.from_coo(edges[:, 0], edges[:, 1], n,
                       edge_capacity=len(edges) + 300)
    w = np.random.default_rng(6).random(jg.edge_capacity) + 0.5
    j = jext.weighted_pagerank(jg, jnp.asarray(w))
    t = text.weighted_pagerank(port_graph(jg), torch.from_numpy(w))
    assert t.iterations == int(j.iterations)
    assert float(np.max(np.abs(np_(t.ranks) - np.asarray(j.ranks)))) <= 1e-12


def _old_counts(steps, sources, weights):
    V = steps.shape[0]
    sel = steps[sources.long()]
    wt = torch.where(sel >= 0, weights[:, None, None],
                     torch.zeros((), dtype=torch.float64))
    return torch.zeros(V, dtype=torch.float64).index_add_(
        0, sel.clamp(0, V - 1).reshape(-1).long(), wt.reshape(-1))


def test_ppr_sums_equal_old_index_add_form():
    edges, n = rmat_edges(8, 8, seed=1)
    g = from_coo(edges[:, 0], edges[:, 1], n, device=CPU)
    index = build_walk_index(g, IndexConfig(num_walks=8, max_len=10,
                                            seed=3))
    rng = np.random.default_rng(3)
    # sources with repeats, as a neighbour slab has them
    sources = torch.from_numpy(rng.integers(0, n, 40).astype(np.int32))
    weights = torch.from_numpy(rng.random(40))
    assert torch.equal(tquery._counts(index.steps, sources, weights),
                       _old_counts(index.steps, sources, weights))
    deg = index.csr.deg.to(torch.float64)
    seeds = torch.tensor([3, 17, 90, 200], dtype=torch.int32)
    est = tquery._counts(index.steps, sources, weights)
    z = 1.0 - index.alpha / (deg[seeds.long()] + 1.0)
    old = est.clone().index_add_(0, seeds.long(),
                                 (1.0 - index.alpha) / (z * 4.0))
    assert torch.equal(tquery._seed_point_mass(est, deg, index.alpha, seeds),
                       old)
    # a repeated seed's masses are summed in seed order
    twice = tquery._seed_point_mass(torch.zeros(n, dtype=torch.float64),
                                    deg, index.alpha,
                                    torch.tensor([7, 7], dtype=torch.int32))
    z7 = 1.0 - index.alpha / (deg[7:8] + 1.0)
    mass = (1.0 - index.alpha) / (z7 * 2.0)
    assert torch.equal(twice[7:8], mass + mass)


def test_push_equals_old_index_add_form():
    _, g, _, _ = _stream_graph()
    vals = torch.from_numpy(np.random.default_rng(8).random(g.num_vertices))
    contrib = torch.where(g.valid, vals[g.src.long()],
                          torch.zeros((), dtype=torch.float64))
    old = torch.zeros(g.num_vertices, dtype=torch.float64).index_add_(
        0, g.dst.long(), contrib)
    assert torch.equal(g.push(vals), old)


# ---------------------------------------------------------------------------
# pull_rows: GraphSAGE's neighbour-row sums
# ---------------------------------------------------------------------------

def _hub_rows_case(d=5):
    """A graph whose vertex 2 has 300 in-edges, some vertices none, dead
    slots, and f32 features."""
    rng = np.random.default_rng(12)
    n = 80
    src = np.concatenate([rng.integers(0, n, 300), rng.integers(0, n, 200)])
    dst = np.concatenate([np.full(300, 2), rng.integers(0, 60, 200)])
    g = from_coo(src, dst, n, dedup=False, device=CPU)
    g = dataclasses.replace(g, valid=g.valid & torch.from_numpy(
        rng.random(g.edge_capacity) < 0.9))
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    return g, x


@pytest.mark.parametrize("k", [1, 3, 64, 1000])
def test_pull_rows_ref_sums_chunks_in_order(k):
    g, x = _hub_rows_case()
    order = tgnn.neighbor_order(g.src, g.dst, g.valid, g.num_vertices)
    out = pull_rows_ref(order, x, chunk_slots=k, slots_at_once=37)
    ptr, src, xs = np_(order.ptr), np_(order.src), np_(x)
    want = np.zeros_like(np_(out))
    for v in range(g.num_vertices):
        total = None
        for b in range(ptr[v], ptr[v + 1], k):
            part = np.zeros(xs.shape[1], np.float32)
            for s in src[b:min(b + k, ptr[v + 1])]:
                part = part + xs[s]             # f32, slot order
            total = part if total is None else total + part
        if total is not None:
            want[v] = total
    assert_bitwise(out, want)


def test_neighbor_sum_equals_old_index_add_form(monkeypatch):
    g, x = _hub_rows_case()
    n = g.num_vertices
    msgs = x[g.src.long()].masked_fill_(~g.valid[:, None], 0.0)
    old = torch.zeros(n, x.shape[1]).index_add_(0, g.dst.long(), msgs)
    # no vertex split: the same adds in the same order
    monkeypatch.setattr(tgnn, "pull_rows",
                        lambda o, f, **kw: pc.pull_rows(
                            o, f, chunk_slots=10_000, **kw))
    assert torch.equal(tgnn.neighbor_sum(x, g.src, g.dst, g.valid, n), old)
    # the hub cut into chunks of 16: another order, within tolerance
    monkeypatch.setattr(tgnn, "pull_rows",
                        lambda o, f, **kw: pc.pull_rows(
                            o, f, chunk_slots=16, **kw))
    split = tgnn.neighbor_sum(x, g.src, g.dst, g.valid, n)
    scale = float(old.abs().max())
    assert float((split - old).abs().max()) <= 1e-5 * scale
    assert not torch.equal(split, old)
