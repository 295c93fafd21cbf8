"""Port parity: graph substrate and generators, bitwise against ``repro``.

Slot assignment and ``valid`` after every batch of a seeded stream, the
touched mask, the DF initial affected set, reachability and the CSR order
must equal the reference's bit for bit, across all three stream regimes.
"""
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.core import pagerank as jpr
from repro.graph import dynamic as jdyn
from repro.graph import generators as jgen
from repro.graph import structure as jstr

from repro_torch.core import pagerank as tpr
from repro_torch.graph import dynamic as tdyn
from repro_torch.graph import generators as tgen
from repro_torch.graph import structure as tstr
from test_torch_common import CPU, assert_bitwise, assert_graph_equal, \
    port_graph, port_update


@pytest.mark.parametrize("scale,ef,seed", [(6, 4, 0), (7, 8, 3), (8, 4, 5)])
def test_rmat_matches_reference(scale, ef, seed):
    a, n_a = jgen.rmat_edges(scale, ef, seed=seed)
    b, n_b = tgen.rmat_edges(scale, ef, seed=seed)
    assert n_a == n_b
    assert_bitwise(b, a, "rmat")


def test_other_generators_match_reference():
    assert_bitwise(tgen.erdos_renyi_edges(200, 900, seed=4)[0],
                   jgen.erdos_renyi_edges(200, 900, seed=4)[0])
    assert_bitwise(tgen.temporal_stream_edges(300, 500, seed=2),
                   jgen.temporal_stream_edges(300, 500, seed=2))
    edges, n = jgen.rmat_edges(7, 4, seed=1)
    for x, y in zip(tgen.random_batch_update(edges, n, 50, seed=3),
                    jgen.random_batch_update(edges, n, 50, seed=3)):
        assert_bitwise(x, y)


@pytest.mark.parametrize("regime", jgen.STREAM_REGIMES)
def test_update_stream_matches_reference(regime):
    e1, n1, b1 = tgen.update_stream(6, 4, regime=regime, seed=9)
    e2, n2, b2 = jgen.update_stream(6, 4, regime=regime, seed=9)
    assert n1 == n2 and len(b1) == len(b2)
    assert_bitwise(e1, e2)
    for (d1, i1), (d2, i2) in zip(b1, b2):
        assert_bitwise(d1, d2)
        assert_bitwise(i1, i2)


def test_from_coo_dedups_like_reference():
    rng = np.random.default_rng(0)
    e = rng.integers(0, 40, size=(300, 2)).astype(np.int32)  # with repeats
    ref = jstr.from_coo(e[:, 0], e[:, 1], 40)
    port = tstr.from_coo(e[:, 0], e[:, 1], 40, device=CPU)
    assert_graph_equal(port, ref)
    ref = jstr.from_coo(e[:, 0], e[:, 1], 40, edge_capacity=400,
                        dedup=False)
    port = tstr.from_coo(e[:, 0], e[:, 1], 40, edge_capacity=400,
                         dedup=False, device=CPU)
    assert_graph_equal(port, ref)
    with pytest.raises(ValueError, match="exceed capacity"):
        tstr.from_coo(e[:, 0], e[:, 1], 40, edge_capacity=10, dedup=False,
                      device=CPU)


def _check_derived(tg, jg, what):
    for loop in (True, False):
        assert_bitwise(tg.out_degree(loop), jg.out_degree(loop), what)
        assert_bitwise(tg.in_degree(loop), jg.in_degree(loop), what)
    assert int(tg.num_valid_edges()) == int(jg.num_valid_edges())
    tc, jc = tg.to_device_csr(), jg.to_device_csr()
    for name in ("indptr", "indices", "deg"):
        assert_bitwise(getattr(tc, name), getattr(jc, name),
                       f"{what} csr.{name}")
    for x, y in zip(tg.to_host_csr(), jg.to_host_csr()):
        assert_bitwise(x, y, f"{what} host csr")
    assert_graph_equal(tstr.sort_edges_by_dst(tg),
                       jstr.sort_edges_by_dst(jg), f"{what} dst-sorted")


@pytest.mark.parametrize("graph_kind", ["rmat", "uniform"])
@pytest.mark.parametrize("regime", jgen.STREAM_REGIMES)
def test_apply_batch_stream_bitwise(regime, graph_kind):
    edges, n, batches = jgen.update_stream(
        7, 4, regime=regime, graph=graph_kind, num_batches=6,
        batch_size=24, seed=11)
    jg = jstr.from_coo(edges[:, 0], edges[:, 1], n,
                       edge_capacity=len(edges) + 96)
    tg = port_graph(jg)
    rng = np.random.default_rng(5)
    for step, (dels, ins) in enumerate(batches):
        ju = jdyn.make_batch_update(dels, ins, 32, 32)
        tu = tdyn.make_batch_update(dels, ins, 32, 32, device=CPU)
        for x, y in zip(tu, ju):
            assert_bitwise(x, y, f"update {step}")
        jg2 = jdyn.apply_batch(jg, ju)
        tg2 = tdyn.apply_batch(tg, tu)
        assert_graph_equal(tg2, jg2, f"batch {step}")
        assert_bitwise(tg.src, jg.src, "input untouched")
        touched_t = tdyn.touched_vertices_mask(tu, n)
        touched_j = jdyn.touched_vertices_mask(ju, n)
        assert_bitwise(touched_t, touched_j, f"touched {step}")
        assert_bitwise(tpr.initial_affected(tg, tg2, touched_t),
                       jpr.initial_affected(jg, jg2, touched_j),
                       f"initial_affected {step}")
        flags = rng.random(n) < 0.2
        assert_bitwise(tg2.push_or(torch.from_numpy(flags)),
                       jg2.push_or(np.asarray(flags)), f"push_or {step}")
        _check_derived(tg2, jg2, f"batch {step}")
        jg, tg = jg2, tg2
    # reachability over the last pair of snapshots
    assert_bitwise(tpr.reachability_mask(tg, tg2, touched_t),
                   jpr.reachability_mask(jg, jg2, touched_j))


def test_apply_batch_full_capacity_drops_like_reference():
    # more insertions than free slots: the surplus is dropped, the same
    # slots are claimed
    edges, n = jgen.erdos_renyi_edges(32, 60, seed=2)
    jg = jstr.from_coo(edges[:, 0], edges[:, 1], n,
                       edge_capacity=len(edges) + 3)
    ins = np.asarray([[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [1, 2]],
                     np.int32)
    dels = edges[:2]
    ju = jdyn.make_batch_update(dels, ins, 8, 8)
    assert_graph_equal(tdyn.apply_batch(port_graph(jg), port_update(ju)),
                       jdyn.apply_batch(jg, ju))


def test_push_matches_reference():
    edges, n = jgen.rmat_edges(7, 6, seed=8)
    jg = jstr.from_coo(edges[:, 0], edges[:, 1], n)
    vals = np.random.default_rng(1).random(n)
    out = tstr.EdgeListGraph.push(port_graph(jg), torch.from_numpy(vals))
    np.testing.assert_allclose(out.numpy(), np.asarray(jg.push(vals)),
                               rtol=1e-12, atol=0)
