"""Port parity: the range-sharded walk index (``repro_torch.ppr.shard``)
against ``repro.ppr.shard`` and the port's unsharded index.

The same seeded inputs go through both packages on the CPU (R-MAT scale
8, R=64, L=16, as ``tests/test_ppr.py``'s sharded tests).  The port runs
mesh-free (``mesh=None``) and on a test mesh of S positions that repeat
the CPU device, at S = 1, 2, 3 (the last shard padded) and 4.  Held:

  * builds and repairs: bit for bit against the reference's mesh-free
    path and against the port's unsharded index, resharded;
  * a repair chain over a stream: bit for bit a fresh build at its end;
  * the capacity budget: the error names the overflowing shards, and
    ``check=False`` drops exactly the reference's walks;
  * queries: within atol 1e-12 of the unsharded estimate and of the
    reference's sharded one (the shards add in another order);
  * ``ServeEngine(mesh=, ppr_index=)`` on both engines: every published
    index bit for bit the unsharded engine's, one host read a repair;
  * ``launch.serve --mesh test --ppr-walks 8``.
"""
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro import ppr as jppr
from repro.graph import dynamic as jdyn
from repro.graph.generators import random_batch_update, rmat_edges
from repro.graph.structure import from_coo

from repro_torch import ppr as tppr
from repro_torch.device import host_sync_count
from repro_torch.graph.dynamic import apply_batch, touched_vertices_mask
from repro_torch.kernels.pagerank_spmv.shard import ShardCapacityError
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.ppr import shard as tshard
from repro_torch.serve import IngestQueue, RankStore, ServeEngine, \
    ServeMetrics
from test_torch_common import CPU, assert_bitwise, np_, port_graph, \
    port_update

R, L = 64, 16
CFG = dict(num_walks=R, max_len=L, seed=3)


@pytest.fixture(scope="module")
def small():
    edges, n = rmat_edges(8, 8, seed=1)               # 256 vertices
    g = from_coo(edges[:, 0], edges[:, 1], n,
                 edge_capacity=len(edges) + 512)
    return g, edges, n


@pytest.fixture(scope="module")
def indexes(small):
    """(reference index, port index) on the same graph, seed 3."""
    g = small[0]
    return (jppr.build_walk_index(g, jppr.IndexConfig(**CFG)),
            tppr.build_walk_index(port_graph(g), tppr.IndexConfig(**CFG)))


def _batch(small, seed, n_del=8, n_ins=16):
    _, edges, n = small
    dele, ins = random_batch_update(edges, n, max(n_del, n_ins), seed=seed)
    return jdyn.make_batch_update(dele[:n_del], ins[:n_ins], 16, 16)


def _mesh(shards, on_mesh):
    return make_test_mesh(shards, device=CPU, model=shards) if on_mesh \
        else None


def _update(small, seed, **kw):
    """(reference graph, touched) and (port graph, touched) after one
    batch on the fixture's graph."""
    g, _, n = small
    u = _batch(small, seed, **kw)
    tu = port_update(u)
    return ((jdyn.apply_batch(g, u), jdyn.touched_vertices_mask(u, n)),
            (apply_batch(port_graph(g), tu), touched_vertices_mask(tu, n)))


@pytest.mark.parametrize("on_mesh", [False, True])
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_sharded_build_matches_reference_and_unsharded(small, indexes,
                                                       shards, on_mesh):
    """The per-shard build with global walk ids equals the reference's
    sharded build and the port's unsharded build, resharded (S=3 pads
    the last shard with -1 rows); unsharding drops the padding."""
    g = small[0]
    j_index, t_index = indexes
    mesh = _mesh(shards, on_mesh)
    got = tppr.build_sharded_walk_index(port_graph(g),
                                        tppr.IndexConfig(**CFG),
                                        num_shards=shards, mesh=mesh)
    want = jppr.build_sharded_walk_index(g, jppr.IndexConfig(**CFG),
                                         num_shards=shards)
    assert len(got.steps) == shards
    assert got.spec == tuple(want.spec)
    assert_bitwise(got.stacked(), want.steps, "sharded build")
    assert_bitwise(got.stacked(),
                   tppr.shard_walk_index(t_index, shards, mesh).stacked(),
                   "vs the unsharded build, resharded")
    assert_bitwise(tppr.unshard_walk_index(got).steps, t_index.steps,
                   "unshard")
    assert got.nbytes() == want.nbytes()


@pytest.mark.parametrize("on_mesh", [False, True])
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_sharded_repair_bitwise(small, indexes, shards, on_mesh):
    """Sharded repair == the reference's sharded repair == the port's
    unsharded repair, resharded; the counts agree and the CSR follows."""
    j_index, t_index = indexes
    (jg2, jt), (tg2, tt) = _update(small, 7)
    mesh = _mesh(shards, on_mesh)
    want, want_n = jppr.repair_walk_index_sharded(
        jppr.shard_walk_index(j_index, shards), jg2, jt)
    plain, plain_n = tppr.repair_walk_index(t_index, tg2, tt)
    got, got_n = tppr.repair_walk_index_sharded(
        tppr.shard_walk_index(t_index, shards, mesh), tg2, tt)
    assert got_n == want_n == plain_n > 0
    assert_bitwise(got.stacked(), want.steps, "vs the reference")
    assert_bitwise(tppr.unshard_walk_index(got).steps, plain.steps,
                   "vs the unsharded repair")
    assert_bitwise(got.csr.indptr, want.csr.indptr, "csr")
    np.testing.assert_array_equal(
        tppr.shard_stale_counts(tppr.shard_walk_index(t_index, shards), tt),
        jppr.shard_stale_counts(jppr.shard_walk_index(j_index, shards), jt))


def test_sharded_repair_one_host_read(small, indexes):
    """The shards' stale counts are stacked and read once."""
    _, (tg2, tt) = _update(small, 7)
    idx = tppr.shard_walk_index(indexes[1], 4)
    before = host_sync_count()
    _, n = tppr.repair_walk_index_sharded(idx, tg2, tt)
    assert n > 0 and host_sync_count() - before == 1
    before = host_sync_count()
    tppr.repair_walk_index_sharded(idx, tg2, torch.zeros_like(tt))
    assert host_sync_count() - before == 1


def test_sharded_repair_chain_over_stream(small):
    """N sharded repairs == one fresh build on the final graph."""
    g, _, n = small
    cfg = tppr.IndexConfig(num_walks=32, max_len=12, seed=11)
    idx = tppr.build_sharded_walk_index(port_graph(g), cfg, num_shards=4)
    cur = g
    before = dict(tshard.REPAIR_COUNTS)
    for seed in range(4):
        u = _batch(small, 100 + seed, n_del=4, n_ins=8)
        cur = jdyn.apply_batch(cur, u)
        tu = port_update(u)
        idx, _ = tppr.repair_walk_index_sharded(
            idx, port_graph(cur), touched_vertices_mask(tu, n))
    fresh = tppr.build_walk_index(port_graph(cur), cfg)
    assert_bitwise(tppr.unshard_walk_index(idx).steps, fresh.steps,
                   "chain vs fresh build")
    assert tshard.REPAIR_COUNTS["repairs"] - before.get("repairs", 0) == 4


def test_sharded_repair_capacity_budget(small, indexes):
    """Overflow of an explicit budget raises naming the shards;
    ``check=False`` drops exactly the reference's walks (its first
    ``capacity`` stale walks a shard in flat order are re-walked)."""
    j_index, t_index = indexes
    (jg2, jt), (tg2, tt) = _update(small, 3)
    sharded = tppr.shard_walk_index(t_index, 4)
    counts = tppr.shard_stale_counts(sharded, tt)
    assert counts.sum() > 0
    tight = max(1, int(counts.max()) // 2)
    with pytest.raises(ShardCapacityError) as ei:
        tppr.repair_walk_index_sharded(sharded, tg2, tt, capacity=tight)
    assert ei.value.shards
    assert all(counts[s] > tight for s in ei.value.shards)
    dropped0 = tshard.REPAIR_COUNTS["dropped_stale"]
    got, _ = tppr.repair_walk_index_sharded(sharded, tg2, tt,
                                            capacity=tight, check=False,
                                            min_capacity=1)
    assert tshard.REPAIR_COUNTS["dropped_stale"] - dropped0 == sum(
        int(c) - tight for c in counts if c > tight)
    want, _ = jppr.repair_walk_index_sharded(
        jppr.shard_walk_index(j_index, 4), jg2, jt, capacity=tight,
        check=False, min_capacity=1)
    assert_bitwise(got.stacked(), want.steps, "check=False drops")
    full, _ = tppr.repair_walk_index(t_index, tg2, tt)
    gu = np_(tppr.unshard_walk_index(got).steps)
    row_old = (gu == np_(t_index.steps)).all(-1)
    row_new = (gu == np_(full.steps)).all(-1)
    assert np.all(row_old | row_new)
    assert not np.all(row_new) and not np.all(row_old)


@pytest.mark.parametrize("shards", [2, 3, 4])
def test_sharded_query_matches_unsharded(small, indexes, shards):
    """A keyed sum a shard, added in shard order: within 1e-12 of the
    unsharded estimate and the reference's; top-k identical."""
    j_index, t_index = indexes
    sharded = tppr.shard_walk_index(t_index, shards,
                                    _mesh(shards, True))
    j_sharded = jppr.shard_walk_index(j_index, shards)
    for unroll in (True, False):
        for seeds in ([7, 12], [0], [3, 200, 255]):
            est = np_(tppr.ppr_estimate(sharded, seeds, unroll=unroll))
            one = np_(tppr.ppr_estimate(t_index, seeds, unroll=unroll))
            ref = np.asarray(jppr.ppr_estimate(j_sharded, seeds,
                                               unroll=unroll))
            np.testing.assert_allclose(est, one, rtol=0, atol=1e-12)
            np.testing.assert_allclose(est, ref, rtol=0, atol=1e-12)
    vs, _ = tppr.ppr_top_k(sharded, [7], 10)
    v1, _ = tppr.ppr_top_k(t_index, [7], 10)
    assert vs.tolist() == v1.tolist()
    assert tppr.effective_walks(sharded, [7, 12]) == \
        tppr.effective_walks(t_index, [7, 12])


def _serve(small, mesh, engine, cfg, batches=6):
    """Serve a seeded insert/delete feed; the published index a batch and
    the host syncs of each batch."""
    g, edges, n = small
    ingest = IngestQueue(flush_size=8, flush_interval=1e9, device=CPU)
    metrics = ServeMetrics()
    eng = ServeEngine(port_graph(g), ingest, RankStore(), metrics=metrics,
                      engine=engine, mesh=mesh, static_fallback_frac=1.0,
                      kernel_opts=dict(be=32, vb=16,
                                       spill_lanes_per_window=64),
                      ppr_index=cfg)
    eng.bootstrap()
    rng = np.random.default_rng(6)
    out = []
    for _ in range(batches):
        for k in range(8):
            u, v = (int(x) for x in rng.integers(0, n, 2))
            if k % 4 == 3:
                u, v = (int(x) for x in edges[rng.integers(len(edges))])
                ingest.submit("delete", u, v)
            elif u != v:
                ingest.submit("insert", u, v)
        assert eng.step(force=True)
        out.append(eng.store.snapshot().ppr_index)
    return eng, out, metrics


@pytest.mark.parametrize("engine", ["kernel", "xla"])
def test_engine_mesh_shards_index_and_repairs(small, engine):
    """``ServeEngine(mesh=, ppr_index=)`` builds the index sharded at
    bootstrap and each batch's index is the unsharded engine's bit for
    bit; the repair adds one host read to a batch of the mesh engine."""
    cfg = tppr.IndexConfig(num_walks=16, max_len=12, seed=2)
    mesh = make_test_mesh(4, device=CPU)
    eng, got, metrics = _serve(small, mesh, engine, cfg)
    _, want, _ = _serve(small, None, engine, cfg)
    _, bare, bare_metrics = _serve(small, mesh, engine, None)
    shards = mesh.shape["model"]
    for a, b in zip(got, want):
        assert isinstance(a, tppr.ShardedWalkIndex)
        assert len(a.steps) == shards
        assert_bitwise(a.stacked(),
                       tppr.shard_walk_index(b, shards).stacked(),
                       "served index")
    assert metrics.as_dict()["walks_resampled"] > 0
    assert eng.ppr_index is got[-1]
    with_idx = metrics.batch_host_syncs
    without = bare_metrics.batch_host_syncs
    assert [a - b for a, b in zip(with_idx, without)] == [1] * len(got)


def test_launch_serve_mesh_ppr_walks(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--engine", "kernel", "--mesh", "test",
                "--ppr-walks", "8", "--ppr-len", "8", "--events", "600",
                "--flush-size", "200", "--query-every", "200",
                "--min-queries", "1"])
    out = capsys.readouterr().out
    assert "serve complete" in out and "ppr_top1=" in out
