"""Port parity: the PPR walk index (``repro_torch.ppr``), the exact PPR
solvers (``core.extensions``) and PPR serving, against ``repro``.

The same seeded inputs go through both packages on the CPU (R-MAT scale
8, R=64, L=16, as ``tests/test_ppr.py``).  What is held, and how tightly:

* threefry bits, walk builds, stale sets and repairs: bit for bit (the
  draws are a pure function of (key, walk, hop), the hop recurrence is
  integer gathers plus one IEEE f32 multiply);
* index estimates: rtol 1e-12 / atol 1e-15 (``index_add_`` and
  ``segment_sum`` add in different orders);
* exact PPR and weighted PageRank: L∞ ≤ 1e-12 with equal iteration counts;
* estimator functions: exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro import ppr as jppr
from repro.core import extensions as jext
from repro.graph import dynamic as jdyn
from repro.graph.generators import random_batch_update, rmat_edges
from repro.graph.structure import from_coo
from repro.kernels.walk_repair.ref import resample_rows_ref as j_resample_ref
from repro.serve import IngestQueue as JIngest
from repro.serve import QueryClient as JClient
from repro.serve import RankStore as JStore
from repro.serve import ServeEngine as JEngine

from repro_torch import convert
from repro_torch.core import extensions as text
from repro_torch.graph.dynamic import apply_batch, touched_vertices_mask
from repro_torch.kernels.walk_repair import walk_repair as wr
from repro_torch.kernels.walk_repair.ref import resample_rows_ref
from repro_torch.ppr import (IndexConfig, WalkIndex, build_walk_index,
                             diagnostics, effective_walks, error_bound,
                             ppr_estimate, ppr_top_k, precision_at_k,
                             repair_walk_index, stale_walks, threefry,
                             truncation_bias, walks_for_error)
from repro_torch.ppr import query as tquery
from repro_torch.ppr.repair import walk_uniforms
from repro_torch.serve import IngestQueue, QueryClient, RankStore, \
    ServeEngine, ServeMetrics
from test_torch_common import CPU, assert_bitwise, np_, port_graph, \
    port_update

R, L = 64, 16


@pytest.fixture(scope="module")
def small():
    edges, n = rmat_edges(8, 8, seed=1)               # 256 vertices
    g = from_coo(edges[:, 0], edges[:, 1], n,
                 edge_capacity=len(edges) + 512)
    return g, edges, n


@pytest.fixture(scope="module")
def indexes(small):
    """(reference index, port index) on the same graph, seed 3."""
    g, _, _ = small
    j = jppr.build_walk_index(g, jppr.IndexConfig(num_walks=R, max_len=L,
                                                  seed=3))
    t = build_walk_index(port_graph(g), IndexConfig(num_walks=R, max_len=L,
                                                    seed=3))
    return j, t


def _batch(edges, n, size, seed):
    dele, ins = random_batch_update(edges, n, size, seed=seed)
    return jdyn.make_batch_update(dele, ins, max(8, size), max(8, size))


# ---------------------------------------------------------------------------
# threefry: the raw bits first
# ---------------------------------------------------------------------------

_IDS = np.array([0, 1, 2, 5, 127, 128, 4095, 12345678, 2**31 - 2, 2**31 - 1,
                 2**31, 2**31 + 1, 2**32 - 1], np.uint32)


def _bits(x):
    return np_(x).astype(np.int64).astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 3, 2**33 + 5])
def test_threefry_bits_match_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    pk = threefry.prng_key(seed)
    assert_bitwise(np.asarray(pk, np.uint32), np.asarray(key), "PRNGKey")
    j_walk = jax.vmap(jax.random.fold_in, (None, 0))(key, jnp.asarray(_IDS))
    t_walk = threefry.fold_in(pk, torch.from_numpy(_IDS.astype(np.int64)))
    assert_bitwise(np.stack([_bits(t_walk[0]), _bits(t_walk[1])], 1),
                   np.asarray(j_walk), "fold_in(key, walk id)")
    for t in (0, 1, 2, 7, L - 1, 1000):
        j_hop = jax.vmap(jax.random.fold_in, (0, None))(j_walk, t)
        t_hop = threefry.fold_in(t_walk, t)
        assert_bitwise(np.stack([_bits(t_hop[0]), _bits(t_hop[1])], 1),
                       np.asarray(j_hop), f"fold_in(., hop {t})")
        j_u = jax.vmap(lambda k: jax.random.uniform(k, (2,), jnp.float32))(
            j_hop)
        t_u = threefry.uniform2(t_hop)
        assert t_u.dtype == torch.float32
        assert_bitwise(np_(t_u).view(np.uint32),
                       np.asarray(j_u).view(np.uint32), f"uniform hop {t}")


def test_walk_uniforms_match_reference_draws(small, indexes):
    from repro.ppr.walks import _walk_draws, _walk_keys
    j_index, t_index = indexes
    ids = np.array([0, 17, 999, 2**14 - 1], np.int64)
    keys = _walk_keys(j_index.key, jnp.asarray(ids, jnp.uint32))
    ref = jnp.stack([_walk_draws(keys, jnp.int32(t)) for t in range(1, L)],
                    axis=1)
    out = walk_uniforms(t_index.key, torch.from_numpy(ids), L)
    assert_bitwise(np_(out).view(np.uint32), np.asarray(ref).view(np.uint32))


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 11])
def test_build_matches_reference(small, seed):
    g, _, n = small
    cfg = dict(num_walks=R, max_len=L, seed=seed)
    j = jppr.build_walk_index(g, jppr.IndexConfig(**cfg))
    t = build_walk_index(port_graph(g), IndexConfig(**cfg))
    assert t.steps.shape == (n, R, L) and t.steps.dtype == torch.int32
    assert_bitwise(t.steps, j.steps, "steps")
    assert t.key == tuple(int(x) for x in np.asarray(j.key))
    for name in ("indptr", "indices", "deg"):
        assert_bitwise(getattr(t.csr, name), getattr(j.csr, name), name)


@pytest.mark.parametrize("chunk", [37, 61, 100])
def test_chunked_build_equals_unchunked(small, indexes, chunk):
    g, _, _ = small
    t = build_walk_index(port_graph(g), IndexConfig(num_walks=R, max_len=L,
                                                    seed=3),
                         chunk_vertices=chunk)
    assert torch.equal(t.steps, indexes[1].steps)


# ---------------------------------------------------------------------------
# repair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [4, 64])
def test_stale_walks_match_reference(small, indexes, size):
    _, edges, n = small
    up = _batch(edges, n, size, seed=size)
    j_stale, j_t0 = jppr.stale_walks(indexes[0].steps,
                                     jdyn.touched_vertices_mask(up, n))
    touched = touched_vertices_mask(port_update(up), n)
    t_stale, t_t0 = stale_walks(indexes[1].steps, touched, chunk_walks=1000)
    assert_bitwise(t_stale, j_stale, "stale")
    assert_bitwise(t_t0, j_t0, "first stale hop")


@pytest.mark.parametrize("size", [4, 64])
def test_repair_matches_reference_and_fresh_build(small, indexes, size):
    g, edges, n = small
    up = _batch(edges, n, size, seed=100 + size)
    g2 = jdyn.apply_batch(g, up)
    j_rep, j_count = jppr.repair_walk_index(
        indexes[0], g2, jdyn.touched_vertices_mask(up, n))
    tu = port_update(up)
    tg2 = apply_batch(port_graph(g), tu)
    touched = touched_vertices_mask(tu, n)
    t_rep, t_count = repair_walk_index(indexes[1], tg2, touched)
    stale, _ = stale_walks(indexes[1].steps, touched)
    assert t_count == j_count == int(stale.sum()) > 0
    assert_bitwise(t_rep.steps, j_rep.steps, "repaired steps")
    fresh = build_walk_index(tg2, IndexConfig(num_walks=R, max_len=L,
                                              seed=3))
    assert torch.equal(t_rep.steps, fresh.steps)
    # untouched walks are kept verbatim; the input index is left intact
    assert torch.equal(t_rep.steps[~stale], indexes[1].steps[~stale])
    assert not torch.equal(t_rep.steps, indexes[1].steps)


def test_repair_stream_matches_reference(small, indexes):
    g, edges, n = small
    j_index, t_index = indexes
    tg = port_graph(g)
    for b in range(5):
        up = _batch(edges, n, 32, seed=10 + b)
        g = jdyn.apply_batch(g, up)
        j_index, j_count = jppr.repair_walk_index(
            j_index, g, jdyn.touched_vertices_mask(up, n))
        tu = port_update(up)
        tg = apply_batch(tg, tu)
        t_index, t_count = repair_walk_index(t_index, tg,
                                             touched_vertices_mask(tu, n))
        assert t_count == j_count, b
        assert_bitwise(t_index.steps, j_index.steps, f"batch {b}")
    fresh = build_walk_index(tg, IndexConfig(num_walks=R, max_len=L, seed=3))
    assert torch.equal(t_index.steps, fresh.steps)


def test_repair_empty_batch_is_noop(small, indexes):
    g, _, n = small
    tg = port_graph(g)
    touched = torch.zeros(n, dtype=torch.bool)
    rep, count = repair_walk_index(indexes[1], tg, touched)
    assert count == 0
    assert rep.steps is indexes[1].steps


def test_repair_chunked_resample_equals_one_launch(small, indexes):
    from repro_torch.ppr import repair as trepair
    g, edges, n = small
    tu = port_update(_batch(edges, n, 64, seed=5))
    tg2 = apply_batch(port_graph(g), tu)
    touched = touched_vertices_mask(tu, n)
    stale, t0 = stale_walks(indexes[1].steps, touched)
    ids, t0_sel = trepair.stale_ids(stale, t0)
    args = (tg2.to_device_csr(), indexes[1].key, indexes[1].steps, ids,
            t0_sel, indexes[1].alpha)
    # 8929 stale walks: three chunks, the last one short
    assert ids.shape[0] > 2 * 3001
    assert torch.equal(trepair._resample(*args, chunk_walks=3001),
                       trepair._resample(*args))


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------

_MAX_ROWS = 333


@pytest.fixture(scope="module")
def resample_case(small, indexes):
    """Seeded rows, first stale hops and uniforms for ``_MAX_ROWS`` walks,
    re-walked by the reference on the graph after one 64-edge batch (so
    suffixes differ from the stored ones).  Each row's result depends on
    that row alone, so the reference's first ``num`` rows are its answer
    for the first ``num`` inputs."""
    g, edges, n = small
    g2 = jdyn.apply_batch(g, _batch(edges, n, 64, seed=64))
    j_csr = jax.jit(type(g2).to_device_csr)(g2)
    rng = np.random.default_rng(0)
    ids = rng.choice(n * R, size=_MAX_ROWS, replace=False)
    rows = np.asarray(indexes[0].steps).reshape(n * R, L)[ids]
    t0 = rng.integers(0, L, size=_MAX_ROWS).astype(np.int32)
    u = rng.random((_MAX_ROWS, L - 1, 2), dtype=np.float32)
    ref = j_resample_ref(j_csr, jnp.asarray(rows), jnp.asarray(t0),
                         jnp.asarray(u), alpha=0.85)
    t_csr = convert.walk_index_from_numpy(
        np.zeros((n, R, L), np.int32), np_(j_csr.indptr), np_(j_csr.indices),
        np_(j_csr.deg), (0, 0), R, L, 0.85, device=CPU).csr
    return t_csr, rows, t0, u, np.asarray(ref)


@pytest.mark.parametrize("num", [1, 127, 193, _MAX_ROWS])
def test_resample_rows_ref_matches_reference(resample_case, num):
    t_csr, rows, t0, u, ref = resample_case
    args = (t_csr, torch.from_numpy(rows[:num]), torch.from_numpy(t0[:num]),
            torch.from_numpy(u[:num]))
    out = resample_rows_ref(*args, alpha=0.85)
    assert_bitwise(out, ref[:num], "resample_rows_ref")
    assert not np.array_equal(ref, rows)
    # on CPU tensors the wrapper runs the plain version and counts nothing
    before = wr.LAUNCH_COUNTS["walk_repair"]
    assert torch.equal(wr.resample_rows(*args, alpha=0.85), out)
    assert wr.LAUNCH_COUNTS["walk_repair"] == before


def test_resample_rows_length_one_is_identity(indexes):
    rows = torch.arange(6, dtype=torch.int32).view(6, 1)
    out = wr.resample_rows(indexes[1].csr, rows,
                           torch.zeros(6, dtype=torch.int32),
                           torch.zeros((6, 0, 2)), alpha=0.85)
    assert torch.equal(out, rows)


# ---------------------------------------------------------------------------
# queries and estimator
# ---------------------------------------------------------------------------

_SEED_SETS = [[5], [0], [3, 77, 200], list(range(0, 256, 9))]


@pytest.mark.parametrize("unroll", [True, False])
@pytest.mark.parametrize("normalize", [True, False])
def test_ppr_estimate_matches_reference(indexes, unroll, normalize):
    j_index, t_index = indexes
    for seeds in _SEED_SETS:
        ref = np.asarray(jppr.ppr_estimate(j_index, seeds, normalize=normalize,
                                           unroll=unroll))
        out = ppr_estimate(t_index, seeds, normalize=normalize, unroll=unroll)
        assert out.dtype == torch.float64
        np.testing.assert_allclose(np_(out), ref, rtol=1e-12, atol=1e-15,
                                   err_msg=str(seeds))


def test_ppr_estimate_slab_width_does_not_change_result(indexes,
                                                        monkeypatch):
    j_index, t_index = indexes
    deg = np_(t_index.csr.deg)
    hub = int(np.argmax(deg))
    assert deg[hub] > 8
    ref = np.asarray(jppr.ppr_estimate(j_index, [hub, 3]))
    monkeypatch.setattr(tquery, "_MAX_NBR_WIDTH", 8)
    np.testing.assert_allclose(np_(ppr_estimate(t_index, [hub, 3])), ref,
                               rtol=1e-12, atol=1e-15)


def test_ppr_top_k_matches_reference(indexes):
    j_index, t_index = indexes
    for seeds in _SEED_SETS:
        j_idx, j_vals = jppr.ppr_top_k(j_index, seeds, 10)
        t_idx, t_vals = ppr_top_k(t_index, seeds, 10)
        j_vals = np.asarray(j_vals)
        np.testing.assert_allclose(np_(t_vals), j_vals, rtol=0, atol=1e-12)
        # vertices must agree wherever no tie lies within 1e-12
        est = np.asarray(jppr.ppr_estimate(j_index, seeds))
        for i, v in enumerate(np_(t_idx)):
            if np.sum(np.abs(est - j_vals[i]) <= 1e-12) == 1:
                assert v == int(j_idx[i]), (seeds, i)


def test_ppr_query_errors(indexes):
    t_index = indexes[1]
    with pytest.raises(ValueError, match="at least one seed"):
        ppr_estimate(t_index, [])
    with pytest.raises(ValueError, match="out of range"):
        ppr_estimate(t_index, [t_index.num_vertices])
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ppr_estimate(object(), [1])


def test_estimator_functions_match_reference(indexes):
    j_index, t_index = indexes
    for args in [(0.01, 0.05, 0.85, 16), (0.1, 0.5, 0.85, 20, False)]:
        assert walks_for_error(*args) == jppr.walks_for_error(*args)
    for args in [(64, 0.05, 0.85, 16), (8, 0.2, 0.5, 12, False)]:
        assert error_bound(*args) == jppr.error_bound(*args)
    assert truncation_bias(0.85, 16) == jppr.truncation_bias(0.85, 16)
    for seeds in _SEED_SETS:
        assert effective_walks(t_index, seeds) == \
            jppr.effective_walks(j_index, seeds)
    assert diagnostics(t_index) == jppr.diagnostics(j_index)
    exact = np.random.default_rng(0).random(256)
    approx = np.argsort(-exact)[[0, 2, 5, 40, 100]]
    assert precision_at_k(approx, exact, 5) == \
        jppr.precision_at_k(approx, exact, 5)


# ---------------------------------------------------------------------------
# exact PPR and weighted PageRank
# ---------------------------------------------------------------------------

def _assert_result(t, j):
    assert t.iterations == int(j.iterations)
    linf = float(np.max(np.abs(np_(t.ranks) - np.asarray(j.ranks))))
    assert linf <= 1e-12, linf


def _warm_inputs(small, seed):
    g, edges, n = small
    up = _batch(edges, n, 16, seed=seed)
    g2 = jdyn.apply_batch(g, up)
    touched = jdyn.touched_vertices_mask(up, n)
    tu = port_update(up)
    return (g, g2, touched), (port_graph(g), apply_batch(port_graph(g), tu),
                              touched_vertices_mask(tu, n))


def test_personalized_pagerank_matches_reference(small):
    g, _, n = small
    mask = np.zeros(n, bool)
    mask[[5, 40, 41]] = True
    j = jext.personalized_pagerank(g, jnp.asarray(mask))
    t = text.personalized_pagerank(port_graph(g), torch.from_numpy(mask))
    _assert_result(t, j)
    (jg, jg2, jt), (tg, tg2, tt) = _warm_inputs(small, seed=7)
    j2 = jext.personalized_pagerank(jg2, jnp.asarray(mask), j.ranks, jg, jt)
    t2 = text.personalized_pagerank(tg2, torch.from_numpy(mask), t.ranks, tg,
                                    tt)
    _assert_result(t2, j2)
    assert_bitwise(t2.affected_ever, j2.affected_ever)


def test_weighted_pagerank_matches_reference(small):
    g, _, _ = small
    w = np.random.default_rng(4).random(g.edge_capacity) + 0.5
    j = jext.weighted_pagerank(g, jnp.asarray(w))
    t = text.weighted_pagerank(port_graph(g), torch.from_numpy(w))
    _assert_result(t, j)
    (jg, jg2, jt), (tg, tg2, tt) = _warm_inputs(small, seed=8)
    j2 = jext.weighted_pagerank(jg2, jnp.asarray(w), j.ranks, jg, jt)
    t2 = text.weighted_pagerank(tg2, torch.from_numpy(w), t.ranks, tg, tt)
    _assert_result(t2, j2)


# ---------------------------------------------------------------------------
# serving with an index
# ---------------------------------------------------------------------------

_CFG = dict(num_walks=16, max_len=12, seed=2)


def _serve_pair(small, ppr=True, engine="xla"):
    g, _, _ = small
    j_ing = JIngest(flush_size=64, flush_interval=1e9)
    t_ing = IngestQueue(flush_size=64, flush_interval=1e9, device=CPU)
    j = JEngine(g, j_ing, JStore(), engine=engine,
                kernel_opts=dict(tune=False, use_kernel=False),
                ppr_index=jppr.IndexConfig(**_CFG) if ppr else None)
    t = ServeEngine(port_graph(g), t_ing, RankStore(), metrics=ServeMetrics(),
                    engine=engine, kernel_opts=dict(tune=False),
                    ppr_index=IndexConfig(**_CFG) if ppr else None)
    return (j, j_ing), (t, t_ing)


def _feed(ings, edges, n, b, size=48):
    dele, ins = random_batch_update(edges, n, size, seed=50 + b)
    for ing in ings:
        for u, v in dele:
            ing.submit_delete(int(u), int(v))
        for u, v in ins:
            ing.submit_insert(int(u), int(v))


def _serve_stream(small, engine, batches):
    """Both packages' engines (index on) after ``batches`` forced steps,
    and each step's (reference, port) snapshots."""
    _, edges, n = small
    (j, j_ing), (t, t_ing) = _serve_pair(small, engine=engine)
    j.bootstrap()
    t.bootstrap()
    snaps = []
    for b in range(batches):
        _feed((j_ing, t_ing), edges, n, b)
        assert j.step(force=True) and t.step(force=True)
        snaps.append((j.store.snapshot(), t.store.snapshot()))
    return (j, j_ing), (t, t_ing), snaps


@pytest.fixture(scope="module")
def xla_stream(small):
    """One xla-engine stream, shared by the index and routing tests."""
    return _serve_stream(small, "xla", 3)


@pytest.mark.parametrize("engine", ["xla", "kernel"])
def test_serve_engine_keeps_index(small, xla_stream, engine):
    (j, _), (t, _), snaps = (xla_stream if engine == "xla" else
                             _serve_stream(small, engine, 3))
    for b, (js, ts) in enumerate(snaps):
        assert ts.generation == js.generation == b + 1
        assert_bitwise(ts.ppr_index.steps, js.ppr_index.steps, f"batch {b}")
        fresh = build_walk_index(ts.graph, IndexConfig(**_CFG))
        assert torch.equal(ts.ppr_index.steps, fresh.steps)
    assert snaps[-1][1].ppr_index is t.ppr_index
    assert t.metrics.walks_resampled == j.metrics.walks_resampled > 0


def test_index_adds_one_host_sync_per_batch(small):
    _, edges, n = small
    (_, _), (t, t_ing) = _serve_pair(small, ppr=True)
    (_, _), (u, u_ing) = _serve_pair(small, ppr=False)
    t.bootstrap()
    u.bootstrap()
    for b in range(3):
        _feed((t_ing, u_ing), edges, n, b)
        assert t.step(force=True) and u.step(force=True)
    assert u.store.snapshot().ppr_index is None
    assert [a - b for a, b in zip(t.metrics.batch_host_syncs,
                                  u.metrics.batch_host_syncs)] == [1, 1, 1]


def test_serve_engine_adopts_prebuilt_index(small, indexes):
    g, _, _ = small
    t = ServeEngine(port_graph(g), IngestQueue(device=CPU), RankStore(),
                    ppr_index=indexes[1])
    t.bootstrap()
    assert t.store.snapshot().ppr_index is indexes[1]
    with pytest.raises(TypeError, match="IndexConfig or a WalkIndex"):
        ServeEngine(port_graph(g), IngestQueue(device=CPU), RankStore(),
                    ppr_index=object())


def test_personalized_top_k_routes_as_reference(small, xla_stream,
                                               monkeypatch):
    import repro_torch.serve.query as sq
    _, _, n = small
    (j, j_ing), (t, t_ing), snaps = xla_stream
    gen = len(snaps)
    jq, tq = JClient(j.store, j_ing), QueryClient(t.store, t_ing)
    deg = np_(t.ppr_index.csr.deg)
    hub, thin = int(np.argmax(deg)), int(np.argmin(deg))
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return text.personalized_pagerank(*a, **kw)

    monkeypatch.setattr(sq, "personalized_pagerank", counted)
    for seeds, mode, kw in [([hub], "auto", {}), ([thin], "auto", {}),
                            ([hub], "index", {}), ([hub], "exact", {}),
                            ([hub], "auto", dict(tol=1e-8))]:
        before = len(calls)
        jr = jq.personalized_top_k(seeds, 5, mode=mode, **kw)
        tr = tq.personalized_top_k(seeds, 5, mode=mode, **kw)
        # thin seeds and solver options go exact; hubs go to the index
        assert (len(calls) > before) == (mode == "exact" or seeds == [thin]
                                         or bool(kw))
        assert tr.generation == jr.generation == gen
        np.testing.assert_allclose(tr.ranks, jr.ranks, rtol=0, atol=1e-12)
    # exact solves are memoized within a generation
    before = len(calls)
    tq.personalized_top_k([hub], 5, mode="exact")
    assert len(calls) == before
    with pytest.raises(ValueError, match="unknown personalized_top_k mode"):
        tq.personalized_top_k([hub], 5, mode="fast")
    with pytest.raises(ValueError, match="exact-path only"):
        tq.personalized_top_k([hub], 5, mode="index", tol=1e-8)
    with pytest.raises(ValueError, match="non-empty"):
        tq.personalized_top_k([n], 5)


def test_personalized_top_k_index_mode_needs_an_index(small):
    (_, _), (t, t_ing) = _serve_pair(small, ppr=False)
    t.bootstrap()
    q = QueryClient(t.store, t_ing)
    with pytest.raises(ValueError, match="carries no walk index"):
        q.personalized_top_k([1], 5, mode="index")
    assert len(q.personalized_top_k([1], 5).vertices) == 5


# ---------------------------------------------------------------------------
# convert and the serve driver
# ---------------------------------------------------------------------------

def test_walk_index_from_numpy_repairs_like_reference(small, indexes):
    g, edges, n = small
    j_index = indexes[0]
    t_index = convert.walk_index_from_numpy(
        np_(j_index.steps), np_(j_index.csr.indptr), np_(j_index.csr.indices),
        np_(j_index.csr.deg), np_(j_index.key), j_index.num_walks,
        j_index.max_len, j_index.alpha, device=CPU)
    assert isinstance(t_index, WalkIndex)
    assert t_index.key == indexes[1].key
    up = _batch(edges, n, 32, seed=77)
    g2 = jdyn.apply_batch(g, up)
    j_rep, j_count = jppr.repair_walk_index(
        j_index, g2, jdyn.touched_vertices_mask(up, n))
    tu = port_update(up)
    t_rep, t_count = repair_walk_index(
        t_index, apply_batch(port_graph(g), tu), touched_vertices_mask(tu, n))
    assert t_count == j_count
    assert_bitwise(t_rep.steps, j_rep.steps)


def test_launch_serve_with_ppr_index_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main
    rc = main(["--device", "cpu", "--events", "32", "--flush-size", "32",
               "--query-every", "32", "--ppr-walks", "8", "--ppr-len", "8",
               "--min-queries", "3"])
    out = capsys.readouterr().out
    assert rc == 0 and "serve complete" in out and "ppr_top1=" in out
    assert '"walks_resampled": ' in out
