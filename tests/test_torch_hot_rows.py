"""The row sum's hot set and row paths, on the CPU (``pull_rows``' kernel
itself needs the card: ``tests/test_torch_cuda.py``).

``pull_rows`` keeps the rows of the sources with the most live slots in
the card's L2: ``source_ranking`` counts each source's live slots with
``slot_count`` and sorts the sources by count, most first, ties by the
lower id; ``hot_set`` takes at most the budget's rows from the front
(only sources with a live slot), and the kernel tags their live slots by
the sign bit of ``src`` (plain version: ``tag_slots``).  Held here against a NumPy top-k of the out-degrees: the
budget, the ties, the tags, the empty cases, and the cache (one ranking
an order, one hot set a width).  ``row_path`` picks the kernel's loads
from d and x's address.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.graph.generators import rmat_edges
from repro_torch.graph.structure import from_coo
from repro_torch.kernels.pull_contrib import pull_contrib as pc
from repro_torch.kernels.segment_ops import plan as tplan
from repro_torch.models.gnn import neighbor_order
from test_torch_common import CPU, np_


def _order(kind="rmat", seed=3):
    """A pull order: R-MAT 2^10 with a tenth of its slots dead
    (``rmat``), or sources of equal out-degree everywhere (``ties``: each
    source u < 40 sends 3 edges), or no live slot (``dead``)."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        n = 64
        src = np.repeat(np.arange(40), 3)
        dst = (src + np.tile([1, 2, 3], 40)) % n
        g = from_coo(src, dst, n, device=CPU)
    else:
        edges, n = rmat_edges(10, 8, seed=seed)
        g = from_coo(edges[:, 0], edges[:, 1], n, device=CPU)
        keep = torch.from_numpy(rng.random(g.edge_capacity) < 0.9)
        g = dataclasses.replace(
            g, valid=g.valid & (keep if kind == "rmat" else ~keep & False))
    return neighbor_order(g.src, g.dst, g.valid, g.num_vertices), \
        g.num_vertices


def _np_top(order, n, rows):
    """The NumPy hot set: the live out-degrees, the sources sorted by
    (-count, id), the first ``rows`` of them that have a live slot."""
    live = np_(order.src)[:int(order.ptr[-1])]
    count = np.bincount(live, minlength=n)
    ranked = np.lexsort((np.arange(n), -count))[:rows]
    return set(ranked[count[ranked] > 0].tolist()), count


@pytest.mark.parametrize("rows", [1, 7, 50, 400, 5000])
def test_hot_set_is_numpy_top_k_within_budget(rows):
    order, n = _order()
    hot = pc.hot_set(order, n, rows)
    want, count = _np_top(order, n, rows)
    got = set(torch.nonzero(hot.hot).flatten().tolist())
    assert got == want
    assert len(got) <= rows
    # the ranking itself: counts of the live slots, most first
    c, rank = pc.source_ranking(order, n)
    assert np.array_equal(np_(c), count)
    assert np.all(np.diff(np_(c)[np_(rank)]) <= 0)


def test_hot_set_breaks_ties_by_lower_id():
    order, n = _order("ties")
    for rows in (1, 5, 17, 39):
        hot = pc.hot_set(order, n, rows)
        assert torch.nonzero(hot.hot).flatten().tolist() == list(range(rows))
        again = pc.hot_set(order, n, rows)
        assert torch.equal(again.tag, hot.tag)
    # sources without a live slot are never hot, however large the budget
    assert int(pc.hot_set(order, n, n).hot.sum()) == 40


@pytest.mark.parametrize("kind", ["rmat", "ties"])
def test_hot_tag_round_trips_to_the_order_src(kind):
    order, n = _order(kind)
    hot = pc.hot_set(order, n, 30)
    src = pc.tag_slots(order, hot)
    tagged = src < 0
    # tagged exactly on the live slots of hot sources
    live = torch.arange(order.src.shape[0]) < order.ptr[-1]
    assert torch.equal(tagged, live & hot.hot[order.src.long()])
    assert int(tagged.sum()) == int(
        pc.source_ranking(order, n)[0][hot.hot].sum())
    assert torch.equal(src & 0x7FFFFFFF, order.src)
    assert torch.equal(src[~tagged], order.src[~tagged])
    assert src.dtype == torch.int32
    assert torch.equal(hot.tag < 0, hot.hot)


@pytest.mark.parametrize("kind,rows", [("rmat", 0), ("dead", 10),
                                       ("dead", 0)])
def test_hot_set_empty_for_no_budget_or_no_live_slot(kind, rows):
    order, n = _order(kind)
    hot = pc.hot_set(order, n, rows)
    assert not bool(hot.hot.any())
    assert torch.equal(pc.tag_slots(order, hot), order.src)
    assert int(pc.cached_hot_set(order, n, 602, 0).hot.sum()) == 0


def test_cached_hot_set_one_ranking_an_order(monkeypatch):
    order, n = _order()
    built = []
    ranking = pc.source_ranking
    monkeypatch.setattr(pc, "source_ranking",
                        lambda *a: built.append(a) or ranking(*a))
    wide = pc.cached_hot_set(order, n, 602, 4 * 602 * 20)
    narrow = pc.cached_hot_set(order, n, 128, 4 * 128 * 20 * 4)
    assert len(built) == 1                  # shared by both widths
    assert int(wide.hot.sum()) == 20 and int(narrow.hot.sum()) == 80
    assert pc.cached_hot_set(order, n, 602, 4 * 602 * 20) is wide
    # the budget's rows, not its bytes, key a hot set
    assert pc.cached_hot_set(order, n, 602, 4 * 602 * 20 + 7) is wide
    # another src tensor on the same ptr: built anew, not the stale one
    other = order._replace(src=order.src.flip(0).contiguous())
    fresh = pc.cached_hot_set(other, n, 602, 4 * 602 * 20)
    assert fresh is not wide and torch.equal(
        pc.tag_slots(other, fresh) & 0x7FFFFFFF, other.src)
    assert len(built) == 2


def test_cached_values_go_with_their_tensor():
    es = torch.tensor([0, 3, 5], dtype=torch.int32)
    calls = []
    first = tplan.cached(es, "k", lambda: calls.append(1) or object())
    assert tplan.cached(es, "k", lambda: calls.append(1) or object()) \
        is first
    assert tplan.cached(es, "j", lambda: "other") == "other"
    assert len(calls) == 1
    key = id(es)
    del es, first
    assert key not in tplan._PLANS


@pytest.mark.parametrize("d,ptr,want", [
    (602, 0, (2, 10)), (602, 8, (2, 10)), (602, 4, (1, 8)),
    (128, 0, (4, 1)), (128, 8, (2, 10)), (128, 4, (1, 8)),
    (256, 16, (4, 1)), (640, 16, (4, 1)), (2000, 16, (4, 1)),
    (250, 8, (2, 10)), (37, 0, (1, 8)), (5, 16, (1, 8))])
def test_row_path_from_width_and_address(d, ptr, want):
    vec, loads = pc.row_path(d, ptr)
    assert (vec, loads) == want
    assert loads == pc.ROW_PATHS[vec] and d % vec == 0
    assert ptr % (4 * vec) == 0
