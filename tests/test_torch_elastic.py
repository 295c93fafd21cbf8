"""Port parity: replica membership, the serving state's rescale, the graph
partition, straggler mitigation and the serve engine's iteration budget
(``ft/elastic.py``, ``graph/partition.py``, ``ft/straggler.py``,
``ServeEngine(iteration_budget=)``) against ``repro``.

Partition and straggler arrays are host NumPy and must be equal to the
reference's.  The budget's engine run must match the reference's per-step
iterations, carry-overs and generations, with ranks within L∞ 1e-6.
"""
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.ft import elastic as jel
from repro.ft import straggler as jst
from repro.graph import generators as jgen
from repro.graph import partition as jpart
from repro.graph import structure as jstr
from repro.serve import IngestQueue as JIngest
from repro.serve import RankStore as JStore
from repro.serve import ServeEngine as JEngine

from repro_torch.ft import elastic as el
from repro_torch.ft import straggler as st
from repro_torch.graph import partition as part
from repro_torch.serve import IngestQueue, RankStore, ServeEngine, \
    ServeMetrics
from test_torch_common import CPU, np_, port_graph

N = 64


def _rmat(scale=9, seed=13):
    edges, n = jgen.rmat_edges(scale, 8, seed=seed)
    return jstr.from_coo(edges[:, 0], edges[:, 1], n,
                         edge_capacity=len(edges) + 8)


# ---------------------------------------------------------------------------
# membership
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", [el, jel], ids=["port", "reference"])
def test_replica_roster_membership_and_liveness(mod):
    r = mod.ReplicaRoster(heartbeat_timeout=1.0)
    r.join("a", now=0.0)
    r.beat("b", now=0.5)                      # implicit join via beat
    assert r.members() == ["a", "b"] and r.joins == 2
    assert r.alive(now=1.0) == ["a", "b"]
    assert r.alive(now=1.2) == ["b"]          # a's beat expired
    assert not r.is_alive("a", now=1.2)
    r.beat("a", now=1.3)
    assert r.is_alive("a", now=1.5)
    r.leave("a")
    assert r.members() == ["b"] and r.leaves == 1
    r.leave("ghost")                          # unknown leave is a no-op
    assert r.leaves == 1


# ---------------------------------------------------------------------------
# rescale of the serving state, from either package's checkpoint
# ---------------------------------------------------------------------------

def _serve_a_few(store_cls, engine_cls, ingest_cls, ckpt_dir, port):
    edges, n = jgen.erdos_renyi_edges(N, 300, seed=2)
    jg = jstr.from_coo(edges[:, 0], edges[:, 1], n,
                       edge_capacity=len(edges) + 256)
    kw = dict(device=CPU) if port else {}
    ing = ingest_cls(flush_size=8, flush_interval=1e9, **kw)
    store = store_cls(ckpt_dir=str(ckpt_dir), ckpt_every=2)
    eng = engine_cls(port_graph(jg) if port else jg, ing, store)
    eng.bootstrap()
    rng = np.random.default_rng(4)
    for _ in range(40):
        u, v = (int(x) for x in rng.integers(0, N, 2))
        if u != v:
            ing.submit_insert(u, v)
    eng.drain()
    snap = store.snapshot()
    return snap.generation, snap.last_seq, np_(snap.ranks)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_rescale_serving_state_restores_either_package(writer, tmp_path):
    if writer == "port":
        gen, seq, ranks = _serve_a_few(RankStore, ServeEngine, IngestQueue,
                                       tmp_path, port=True)
    else:
        gen, seq, ranks = _serve_a_few(JStore, JEngine, JIngest, tmp_path,
                                       port=False)
    # the newest checkpoint is the newest even generation
    want = gen - gen % 2
    g, s, r = el.rescale_serving_state(str(tmp_path), N, device=CPU)
    jg, js, jr = jel.rescale_serving_state(str(tmp_path), N)
    assert g == jg == want and s == js
    assert r.dtype == torch.float64 and r.device.type == "cpu"
    assert np.array_equal(r.numpy(), np.asarray(jr))
    if want == gen:
        assert s == seq and np.array_equal(r.numpy(), ranks)


def test_rescale_serving_state_empty_and_mesh_paths(tmp_path):
    """An empty directory restores nothing; the mesh paths are ported
    (``tests/test_torch_dist.py`` rescales a served stream): with no
    checkpoint they restore nothing, and a bad sharding is refused."""
    from repro_torch.launch.mesh import make_test_mesh
    assert el.rescale_serving_state(str(tmp_path / "none"), N,
                                    device=CPU) == (None, None, None)
    assert el.rescale_state(str(tmp_path), {}, {}) == (None, None)
    mesh = make_test_mesh(4, device=CPU)
    g = port_graph(jstr.from_coo(np.arange(4), np.arange(1, 5), N))
    idx, ranks, part = el.rescale_pagerank_state(str(tmp_path), g, mesh)
    assert idx is None and ranks is None
    assert part.src.shape[:2] == (2, 2) and part.num_vertices == N
    from repro_torch.ft import checkpoint as ck
    ck.save(str(tmp_path), 3, dict(x=torch.zeros(2)))
    with pytest.raises(TypeError, match="NamedSharding"):
        el.rescale_state(str(tmp_path), dict(x=torch.zeros(2)),
                         dict(x=object()))


# ---------------------------------------------------------------------------
# partition and straggler mitigation: arrays equal to the reference's
# ---------------------------------------------------------------------------

def _assert_partition_equal(a, b):
    for f in ("src", "dst_local", "valid", "vtx_starts"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.num_vertices, a.v_per_shard, a.model_shards, a.edge_shards) \
        == (b.num_vertices, b.v_per_shard, b.model_shards, b.edge_shards)


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (4, 4)])
@pytest.mark.parametrize("balanced", [False, True])
def test_partition_graph_equals_reference(shape, balanced):
    jg = _rmat()
    rng = np.random.default_rng(1)
    mask = rng.random(jg.edge_capacity) < 0.3 if balanced else None
    _assert_partition_equal(
        part.partition_graph(port_graph(jg), *shape, balance_by_active=mask),
        jpart.partition_graph(jg, *shape, balance_by_active=mask))
    assert part.vertices_per_shard(1000, 3) == \
        jpart.vertices_per_shard(1000, 3)


def test_stripe_skew_and_rebalance_equal_reference():
    jg = _rmat()
    g = port_graph(jg)
    affected = np.zeros(jg.num_vertices, bool)
    affected[: jg.num_vertices // 16] = True     # a concentrated frontier
    assert np.array_equal(st.active_edge_mask(g, affected),
                          jst.active_edge_mask(jg, affected))
    static = part.partition_graph(g, 4, 4)
    rebal = st.rebalance(g, affected, 4, 4)
    _assert_partition_equal(rebal, jst.rebalance(jg, affected, 4, 4))
    assert st.stripe_skew(static, affected) == \
        jst.stripe_skew(jpart.partition_graph(jg, 4, 4), affected)
    assert st.stripe_skew(rebal, affected) == \
        jst.stripe_skew(jst.rebalance(jg, affected, 4, 4), affected)
    # active-first striping never makes the skew worse
    assert st.stripe_skew(rebal, affected) <= \
        st.stripe_skew(static, affected) + 1e-9


@pytest.mark.parametrize("as_tensor", [False, True])
def test_iteration_budget_carries_frontier(as_tensor):
    wrap = torch.from_numpy if as_tensor else (lambda a: a)
    b = st.IterationBudget(max_iter_per_batch=10)
    fresh = np.zeros(8, bool)
    fresh[0] = True
    assert b.seeds_for_batch(wrap(fresh))[0]
    leftover = np.zeros(8, bool)
    leftover[3] = True
    b.after_batch(converged=False, frontier=wrap(leftover))
    leftover[3] = False                 # the budget kept its own copy
    seeds = b.seeds_for_batch(wrap(fresh))
    assert seeds[0] and seeds[3]
    b.after_batch(converged=True, frontier=wrap(leftover))
    assert not b.seeds_for_batch(wrap(fresh))[3]
    assert b.carried_frontier is None


# ---------------------------------------------------------------------------
# ServeEngine(iteration_budget=) against the reference
# ---------------------------------------------------------------------------

def _budget_run(budget, engine="xla", port=True, feed_seed=2):
    edges, n = jgen.erdos_renyi_edges(N, 300, seed=2)
    jg = jstr.from_coo(edges[:, 0], edges[:, 1], n,
                       edge_capacity=len(edges) + 256)
    if port:
        ing = IngestQueue(flush_size=16, flush_interval=1e9, device=CPU)
        metrics = ServeMetrics()
        eng = ServeEngine(port_graph(jg), ing, RankStore(), metrics=metrics,
                          engine=engine, static_fallback_frac=2.0,
                          iteration_budget=budget,
                          kernel_opts=dict(tune=False))
    else:
        from repro.serve import ServeMetrics as JMetrics
        ing = JIngest(flush_size=16, flush_interval=1e9)
        metrics = JMetrics()
        eng = JEngine(jg, ing, JStore(), metrics=metrics, engine=engine,
                      static_fallback_frac=2.0, iteration_budget=budget,
                      kernel_opts=dict(tune=False, use_kernel=False))
    eng.bootstrap()
    rng = np.random.default_rng(feed_seed)
    gens = []
    for _ in range(64):
        u, v = rng.integers(0, N, 2)
        if u != v:
            ing.submit_insert(int(u), int(v))
        if eng.step():
            gens.append(eng.store.generation)
    eng.drain()
    gens.append(eng.store.generation)
    return eng, metrics, gens


@pytest.mark.parametrize("budget", [2, "object"])
def test_serve_engine_budget_matches_reference(budget):
    make = (lambda: st.IterationBudget(2)) if budget == "object" else \
        (lambda: 2)
    t, tm, tg = _budget_run(make(), port=True)
    j, jm, jg = _budget_run(jst.IterationBudget(2) if budget == "object"
                            else 2, port=False)
    assert tg == jg
    assert tm.batch_iterations == jm.batch_iterations
    assert max(tm.batch_iterations) <= 2          # the cap held
    assert tm.budget_carryover == jm.budget_carryover >= 1
    linf = float(np.max(np.abs(np_(t.store.snapshot().ranks)
                               - np_(j.store.snapshot().ranks))))
    assert linf <= 1e-6


def test_serve_engine_budget_on_the_kernel_engine():
    """The kernel engine caps its f32 phase and its f64 polish each: at
    most twice the cap a batch, carried as the reference carries it."""
    t, tm, tg = _budget_run(2, engine="kernel", port=True)
    j, jm, jg = _budget_run(2, engine="kernel", port=False)
    assert tg == jg
    assert max(tm.batch_iterations) <= 4
    assert tm.budget_carryover >= 1
    linf = float(np.max(np.abs(np_(t.store.snapshot().ranks)
                               - np_(j.store.snapshot().ranks))))
    assert linf <= 1e-6


@pytest.mark.parametrize("engine", ["xla", "kernel"])
def test_budget_that_never_binds_adds_no_sync(engine):
    """A budget reads the solve's delta only on a batch whose solve used
    every iteration of its cap: one that never binds leaves every
    batch's syncs, iterations and ranks as they are without a budget."""
    t, tm, tg = _budget_run(500, engine=engine)
    u, um, ug = _budget_run(None, engine=engine)
    assert tg == ug and tm.budget_carryover == um.budget_carryover == 0
    assert tm.batch_host_syncs == um.batch_host_syncs
    assert tm.batch_iterations == um.batch_iterations
    assert torch.equal(t.store.snapshot().ranks, u.store.snapshot().ranks)
