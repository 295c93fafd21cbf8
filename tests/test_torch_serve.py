"""Port parity: the serve loop end to end, against ``repro.serve``.

The same seeded event feed goes through the reference ``ServeEngine``
(``kernel_opts=dict(tune=False, use_kernel=False, ...)``) and the port's.
After every step: ``generation``, ``last_seq`` and ``packed_rebuilds``
equal; ranks L∞ ≤ 1e-6; ``top_k`` vertices equal and their ranks equal
within 1e-12 on the f64 engine.  On the kernel engine the f32 phase sums
in another order than XLA does, so the f64 polish starts elsewhere and
stops within its τ = 1e-10 of the fixed point: there the top-k ranks are
held to the ranks' 1e-6.
"""
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.graph import generators as jgen
from repro.graph import structure as jstr
from repro.serve import IngestQueue as JIngest
from repro.serve import QueryClient as JClient
from repro.serve import RankStore as JStore
from repro.serve import ServeEngine as JEngine
from repro.serve.ingest import coalesce_events as j_coalesce

from repro_torch.ppr import IndexConfig
from repro_torch.serve import IngestQueue, QueryClient, RankStore, \
    ServeEngine, ServeMetrics
from repro_torch.serve.ingest import EdgeEvent, coalesce_events
from test_torch_common import CPU, assert_bitwise, np_, port_graph

N = 64


def _feed(seed, k=150, hot=None):
    """Seeded insert/delete events; ``hot`` skews inserts into the top
    vertex range so windows there overflow their spill lanes."""
    rng = np.random.default_rng(seed)
    feed = []
    for _ in range(k):
        lo = hot if hot is not None and rng.random() < 0.75 else 0
        u, v = int(rng.integers(0, N)), int(rng.integers(lo, N))
        if u != v:
            feed.append((u, v, "i" if rng.random() < 0.8 else "d"))
    return feed


def _engines(engine, kernel_opts, fallback_frac=1.0, method="frontier_prune"):
    edges, n = jgen.erdos_renyi_edges(N, 300, seed=2)
    jg = jstr.from_coo(edges[:, 0], edges[:, 1], n,
                       edge_capacity=len(edges) + 256)
    j_ing = JIngest(flush_size=16, flush_interval=1e9)
    t_ing = IngestQueue(flush_size=16, flush_interval=1e9, device=CPU)
    j = JEngine(jg, j_ing, JStore(), method=method, engine=engine,
                kernel_opts=dict(kernel_opts, tune=False, use_kernel=False),
                static_fallback_frac=fallback_frac)
    t = ServeEngine(port_graph(jg), t_ing, RankStore(), metrics=ServeMetrics(),
                    method=method, engine=engine,
                    kernel_opts=dict(kernel_opts, tune=False),
                    static_fallback_frac=fallback_frac)
    return (j, j_ing, JClient(j.store, j_ing)), (t, t_ing,
                                                QueryClient(t.store, t_ing))


def _run_parity(engine, kernel_opts, feed, **kw):
    (j, j_ing, j_q), (t, t_ing, t_q) = _engines(engine, kernel_opts, **kw)
    assert j.bootstrap() == t.bootstrap() == 0
    steps = 0

    def compare():
        js, ts = j.store.snapshot(), t.store.snapshot()
        assert ts.generation == js.generation
        assert ts.last_seq == js.last_seq
        assert t.metrics.packed_rebuilds == j.metrics.packed_rebuilds
        linf = float(np.max(np.abs(np_(ts.ranks) - np_(js.ranks))))
        assert linf <= 1e-6, (ts.generation, linf)
        jt, tt = j_q.top_k(5), t_q.top_k(5)
        assert tt.generation == jt.generation
        assert_bitwise(tt.vertices, jt.vertices)
        np.testing.assert_allclose(
            tt.ranks, jt.ranks, rtol=0,
            atol=1e-12 if engine == "xla" else 1e-6)

    compare()
    for u, v, kind in feed:
        for ing in (j_ing, t_ing):
            (ing.submit_insert if kind == "i" else ing.submit_delete)(u, v)
        did_j, did_t = j.step(), t.step()
        assert did_j == did_t
        if did_t:
            steps += 1
            compare()
    assert j.drain() == t.drain()
    compare()
    assert steps >= 5
    return j, t


@pytest.mark.parametrize("engine", ["xla", "kernel"])
def test_serve_engine_matches_reference(engine):
    j, t = _run_parity(engine, {}, _feed(11))
    assert t.metrics.packed_rebuilds == 0
    m = t.metrics.as_dict()
    assert m["batches"] == len(j.metrics.update_latency_s)
    assert m["host_syncs_per_batch"] > 0
    if engine == "xla":
        assert t.metrics.batch_iterations == j.metrics.batch_iterations


def test_serve_engine_repack_matches_reference():
    # little spill headroom + skewed growth: windows overflow and both
    # engines repack at the pinned shapes, at the same generations
    _, t = _run_parity("kernel", dict(be=8, vb=16, spill_lanes_per_window=8),
                       _feed(13, k=200, hot=32))
    assert t.metrics.packed_rebuilds >= 1


@pytest.mark.parametrize("fused", [True, False])
def test_serve_engine_repacks_only_on_spill(monkeypatch, fused):
    # a ValueError that is not a spill/overlay overflow (here, the kernel
    # wrapper's input check on the fused step, or packed maintenance on
    # the static-fallback step) propagates and is never taken for an
    # overflow and repacked
    from repro_torch.kernels.pagerank_spmv import ops
    from repro_torch.serve import engine as serve_engine

    def bad_input(*args, **kw):
        raise ValueError("frontier_spmv: src must be contiguous")

    (_, _, _), (t, ing, _) = _engines("kernel", {},
                                      fallback_frac=1.0 if fused else 0.0)
    t.bootstrap()
    if fused:
        monkeypatch.setattr(ops, "frontier_spmv_padded", bad_input)
    else:
        monkeypatch.setattr(serve_engine, "apply_batch_packed", bad_input)
    for u, v, kind in _feed(11)[:16]:
        (ing.submit_insert if kind == "i" else ing.submit_delete)(u, v)
    with pytest.raises(ValueError, match="must be contiguous"):
        t.step(force=True)
    assert t.metrics.packed_rebuilds == 0


@pytest.mark.parametrize("engine", ["xla", "kernel"])
def test_serve_engine_static_fallback_matches_reference(engine):
    _, t = _run_parity(engine, {}, _feed(17, k=100), fallback_frac=0.0)
    assert t.metrics.static_fallbacks == len(t.metrics.update_latency_s)


@pytest.mark.parametrize("method", ["frontier", "traversal", "naive"])
def test_serve_engine_other_methods_match_reference(method):
    _run_parity("kernel", {}, _feed(19, k=100), method=method)


def test_coalesce_matches_reference():
    rng = np.random.default_rng(3)
    events = []
    for seq in range(40):
        u, v = (int(x) for x in rng.integers(0, 8, size=2))
        kind = "insert" if rng.random() < 0.6 else "delete"
        events.append(EdgeEvent(kind, u, v, seq, float(seq)))
    ref = j_coalesce(events, 48, 48)
    out = coalesce_events(events, 48, 48, device=CPU)
    for x, y in zip(out.update, ref.update):
        assert_bitwise(x, y)
    assert out[1:] == ref[1:]


def test_queries_answer_from_the_snapshot():
    (_, _, _), (t, ing, q) = _engines("xla", {})
    t.bootstrap()
    ranks = t.store.snapshot().ranks.numpy()
    r = q.get_ranks([3, 5, 7])
    assert_bitwise(r.ranks, ranks[[3, 5, 7]])
    top = q.top_k(4)
    assert list(top.vertices) == list(np.argsort(-ranks, kind="stable")[:4])
    assert top.generation == 0 and top.staleness_events == 0


def _option_engine(**kw):
    edges, n = jgen.erdos_renyi_edges(N, 100, seed=2)
    g = port_graph(jstr.from_coo(edges[:, 0], edges[:, 1], n,
                                 edge_capacity=len(edges) + 64))
    return ServeEngine(g, IngestQueue(flush_size=16, flush_interval=1e9,
                                      device=CPU), RankStore(),
                       engine="kernel", static_fallback_frac=1.0, **kw)


@pytest.mark.parametrize("opt", [
    "mesh", "mesh+ppr_index", "tune_measure", "tune_cache_path",
    "frontier_frac", "tune", "use_kernel", "delta_budget"])
def test_serve_engine_rejects_unported_options(opt, tmp_path, monkeypatch):
    """The reference's options are ported and do what the reference's do,
    ``mesh=`` with ``ppr_index=`` (the sharded walk index) included."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.kernels.pagerank_spmv.tune import TuneCache
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "t.json"))
    mesh = make_test_mesh(4, device=CPU)
    kw = dict(mesh=dict(mesh=mesh, kernel_opts=dict(be=16, vb=8)),
              **{"mesh+ppr_index": dict(
                  mesh=mesh, kernel_opts=dict(be=16, vb=8),
                  ppr_index=IndexConfig(num_walks=4, max_len=6, seed=1))},
              tune_measure=dict(kernel_opts=dict(tune_measure=True)),
              tune_cache_path=dict(kernel_opts=dict(
                  tune_cache_path=str(tmp_path / "named.json"))),
              frontier_frac=dict(kernel_opts=dict(frontier_frac=0.5)),
              tune=dict(kernel_opts=dict(tune=True, be=64)),
              use_kernel=dict(kernel_opts=dict(use_kernel=False)),
              delta_budget=dict(mesh=mesh, kernel_opts=dict(
                  be=16, vb=8, delta_budget=2)))[opt]
    eng = _option_engine(**kw)
    eng.bootstrap()
    info, geom = eng.tune_info, eng.kernel_geometry
    assert geom is not None
    for _ in range(2):
        for u in range(16):
            eng.ingest.submit("insert", u, (u * 7 + 3) % N)
        assert eng.step(force=True)
    ranks = eng.store.snapshot().ranks
    assert ranks.dtype == torch.float64 and bool(torch.isfinite(ranks).all())
    if opt == "mesh+ppr_index":
        from repro_torch.ppr import ShardedWalkIndex, build_walk_index, \
            unshard_walk_index
        snap = eng.store.snapshot()
        assert isinstance(snap.ppr_index, ShardedWalkIndex)
        assert len(snap.ppr_index.steps) == 2
        fresh = build_walk_index(snap.graph, IndexConfig(
            num_walks=4, max_len=6, seed=1))
        assert torch.equal(unshard_walk_index(snap.ppr_index).steps,
                           fresh.steps)
    elif opt == "mesh":
        assert eng._sharded is not None and eng._sharded.num_shards == 2
        assert eng.metrics.comm_bytes > 0
        assert 0 < eng.metrics.as_dict()["halo_occupancy"] <= 1
    elif opt == "tune_measure":
        assert info.source == "measured"
        assert sum(c[2] is not None for c in info.candidates) == 3
    elif opt == "tune_cache_path":
        assert TuneCache(str(tmp_path / "named.json")).get(info.key) == geom
        assert not (tmp_path / "t.json").exists()
    elif opt == "frontier_frac":
        assert info.key.endswith("-f1e0")
    elif opt == "tune":
        assert info is not None and geom.be == 64
    elif opt == "use_kernel":
        assert eng._kernel_kw["use_kernel"] is False
        with pytest.raises(ValueError, match="use_kernel"):
            _option_engine(kernel_opts=dict(use_kernel="yes"))
        # True insists on the kernel: on CPU tensors the step raises
        eng = _option_engine(kernel_opts=dict(use_kernel=True))
        eng.bootstrap()
        eng.ingest.submit("insert", 1, 2)
        with pytest.raises(ValueError, match="use_kernel=True needs CUDA"):
            eng.step(force=True)
    else:
        # a budget of 2 rows a shard overflows: every shard repacks
        assert eng.metrics.packed_rebuilds == 2
        assert sum(eng.metrics.packed_rebuilds_by_shard.values()) >= 2


def test_rank_store_checkpoints_not_ported(tmp_path):
    """Checkpointed restart is ported now: (ranks, generation, last_seq)
    every ``ckpt_every`` generations, restored as the reference restores
    them (``tests/test_serving.py``)."""
    with pytest.raises(RuntimeError, match="no published snapshot"):
        RankStore().snapshot()
    edges, n = jgen.erdos_renyi_edges(N, 100, seed=2)
    g = port_graph(jstr.from_coo(edges[:, 0], edges[:, 1], n))
    store = RankStore(ckpt_dir=str(tmp_path), ckpt_every=2)
    r0 = torch.full((n,), 1.0 / n, dtype=torch.float64)
    store.publish(g, r0, last_seq=-1)             # gen 0: checkpointed
    store.publish(g, r0 * 2, last_seq=5)          # gen 1: not (every=2)
    store.publish(g, r0 * 3, last_seq=11)         # gen 2: checkpointed
    ranks, gen, last_seq = RankStore(
        ckpt_dir=str(tmp_path), ckpt_every=2).restore_latest(n, CPU)
    assert gen == 2 and last_seq == 11
    assert torch.equal(ranks, r0 * 3)
    assert RankStore().restore_latest(n, CPU) is None


def test_launch_serve_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main
    rc = main(["--device", "cpu", "--engine", "kernel", "--events", "150",
               "--flush-size", "32", "--query-every", "50",
               "--min-queries", "3"])
    out = capsys.readouterr().out
    assert rc == 0 and "serve complete" in out
