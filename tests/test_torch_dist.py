"""Port parity: the multi-device engines (``repro_torch.dist``) on meshes
of 1, 2 and 4 shards that repeat the CPU device.

The reference's multi-device mesh tests fail on this jax, and tier-1 sees
one CPU device, so the reference is no multi-shard oracle.  The port's
mesh engines are held against three things instead:

  * the port's own unsharded engines over the same stream (kernel
    engine: L∞ ≤ 1e-6, the ladder contract; xla: L1 < 5e-5 against a
    static solve, ``tests/test_distributed.py``'s bound);
  * the reference's serve engine on a one-device mesh (L∞ ≤ 1e-6,
    ``tests/test_kernel_sharded.py``);
  * themselves, bit for bit from run to run.

A budget of a few rows a shard forces ``ShardCapacityError`` repacks
mid-stream, counted per shard.  Then ``update_pagerank(mesh=)``, elastic
rescaling from 4 shards onto 2, and the collectives' shard order.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import repro  # noqa: F401
from repro.core.api import update_pagerank as j_update_pagerank
from repro.graph.dynamic import apply_batch as j_apply_batch
from repro.graph.dynamic import make_batch_update as j_make_update
from repro.graph.generators import random_batch_update, update_stream
from repro.graph.structure import from_coo as j_from_coo
from repro.serve import IngestQueue as JIngest
from repro.serve import RankStore as JStore
from repro.serve import ServeEngine as JEngine

from repro_torch.core.api import update_pagerank
from repro_torch.core.pagerank import static_pagerank
from repro_torch.dist.pagerank_dist import build_distributed_step
from repro_torch.ft import checkpoint as ck
from repro_torch.ft.elastic import rescale_pagerank_state
from repro_torch.graph.partition import partition_graph
from repro_torch.kernels.pagerank_spmv.update import pack_graph
from repro_torch.launch.mesh import Mesh, make_test_mesh
from repro_torch.serve import IngestQueue, RankStore, ServeEngine, \
    ServeMetrics
from test_torch_common import CPU, np_, port_graph, port_update

PACK = dict(be=32, vb=16, spill_lanes_per_window=64)


def _stream():
    init, n, batches = update_stream(6, 4, regime="mixed", num_batches=6,
                                     batch_size=16, seed=7)
    cap = len(init) + 6 * 48 + 64
    return init, n, batches, cap


def _feed(ingest, batch, submit):
    dels, ins = batch
    for u, v in dels:
        submit(ingest, "delete", int(u), int(v))
    for u, v in ins:
        submit(ingest, "insert", int(u), int(v))


def _serve_port(mesh=None, engine="kernel", **kernel_opts):
    init, n, batches, cap = _stream()
    g = port_graph(j_from_coo(init[:, 0], init[:, 1], n, edge_capacity=cap))
    ingest = IngestQueue(flush_size=64, flush_interval=1e9, device=CPU)
    eng = ServeEngine(g, ingest, RankStore(), metrics=ServeMetrics(),
                      method="frontier_prune", engine=engine, mesh=mesh,
                      static_fallback_frac=1.0,
                      kernel_opts=dict(PACK, **kernel_opts))
    eng.bootstrap()
    snaps = []
    for b in batches:
        _feed(ingest, b, lambda q, k, u, v: q.submit(k, u, v))
        assert eng.step(force=True)
        snaps.append(eng.store.snapshot().ranks.clone())
    return eng, snaps


def _serve_reference(mesh):
    init, n, batches, cap = _stream()
    g = j_from_coo(init[:, 0], init[:, 1], n, edge_capacity=cap)
    ingest = JIngest(flush_size=64, flush_interval=1e9)
    eng = JEngine(g, ingest, JStore(), method="frontier_prune",
                  engine="kernel", mesh=mesh, static_fallback_frac=1.0,
                  kernel_opts=dict(PACK, use_kernel=False, tune=False))
    eng.bootstrap()
    snaps = []
    for b in batches:
        _feed(ingest, b, lambda q, k, u, v: q.submit(k, u, v))
        assert eng.step(force=True)
        snaps.append(np.asarray(eng.store.snapshot().ranks))
    return snaps


@pytest.fixture(scope="module")
def unsharded():
    return _serve_port()[1]


@pytest.fixture(scope="module")
def reference_one_device():
    return _serve_reference(JMesh(np.asarray(jax.devices()[:1]),
                                  ("model",)))


def _linf(a, b):
    return float(np.max(np.abs(np_(a) - np_(b))))


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("exchange", ["halo", "psum"])
def test_sharded_kernel_stream_matches_unsharded(shards, exchange,
                                                 unsharded,
                                                 reference_one_device):
    mesh = make_test_mesh(shards, device=CPU, model=shards)
    eng, snaps = _serve_port(mesh, exchange=exchange)
    assert eng._sharded.num_shards == shards
    for b, (got, want, ref) in enumerate(zip(snaps, unsharded,
                                             reference_one_device)):
        assert got.dtype == torch.float64
        assert _linf(got, want) <= 1e-6, (b, _linf(got, want))
        assert _linf(got, ref) <= 1e-6, (b, _linf(got, ref))
    m = eng.metrics
    assert m.packed_rebuilds == 0 and m.static_fallbacks == 0
    info = eng._sharded.last_comm_info
    if exchange == "psum":
        assert m.comm_bytes > 0 and info["halo_slots"] == 0
        assert eng._sharded.last_comm_bytes == (
            info["f32_iterations"] * eng._sharded.spec.padded_vertices * 4)
    elif shards > 1:
        assert m.comm_bytes > 0 and 0 < m.as_dict()["halo_occupancy"] <= 1
    # bitwise run to run
    _, again = _serve_port(mesh, exchange=exchange)
    assert all(torch.equal(a, b) for a, b in zip(snaps, again))


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("wire", ["packed", "quantized"])
def test_forced_repack_per_shard(shards, wire, unsharded):
    """A delta budget of 4 rows a shard overflows: the engine repacks
    every shard at the pinned shapes and serves on, within the ladder's
    bound of the unsharded stream, bitwise run to run."""
    mesh = make_test_mesh(shards, device=CPU, model=shards)
    eng, snaps = _serve_port(mesh, delta_budget=4, wire=wire)
    m = eng.metrics
    assert m.packed_rebuilds > 0
    assert set(m.packed_rebuilds_by_shard) <= set(range(shards))
    assert sum(m.packed_rebuilds_by_shard.values()) >= m.packed_rebuilds
    for got, want in zip(snaps, unsharded):
        assert _linf(got, want) <= 1e-6
    _, again = _serve_port(mesh, delta_budget=4, wire=wire)
    assert all(torch.equal(a, b) for a, b in zip(snaps, again))


@pytest.mark.parametrize("devices,model", [(1, 1), (2, 2), (4, 2), (4, 4)])
def test_xla_mesh_stream_matches_static_and_unsharded(devices, model,
                                                      unsharded):
    mesh = make_test_mesh(devices, device=CPU, model=model)
    eng, snaps = _serve_port(mesh, engine="xla")
    _, plain = _serve_port(None, engine="xla")
    graph = eng.store.snapshot().graph
    static = static_pagerank(graph).ranks
    l1 = float((snaps[-1] - static).abs().sum())
    assert l1 < 5e-5, l1
    for got, want, kern in zip(snaps, plain, unsharded):
        assert _linf(got, want) <= 1e-6 and _linf(got, kern) <= 1e-6
    _, again = _serve_port(mesh, engine="xla")
    assert all(torch.equal(a, b) for a, b in zip(snaps, again))


def test_distributed_step_int8_marks_equal_int32():
    """The OR of the stripes' marks over the int8 wire equals the int32
    sum's, bit for bit through the whole solve."""
    init, n, _, cap = _stream()
    g = port_graph(j_from_coo(init[:, 0], init[:, 1], n, edge_capacity=cap))
    mesh = make_test_mesh(4, device=CPU)
    part = partition_graph(g, 2, 2)
    args = [torch.from_numpy(a) for a in (part.src, part.dst_local,
                                          part.valid)]
    v_pad = part.v_per_shard * 2
    pad = lambda x: torch.cat([x, x.new_zeros(v_pad - n)])
    ranks = pad(torch.full((n,), 1.0 / n, dtype=torch.float64))
    inv = pad(1.0 / g.out_degree().to(torch.float64))
    aff = pad(torch.ones(n, dtype=torch.bool))
    outs = [build_distributed_step(mesh, n, prune=True, int8_frontier=q,
                                   full_result=True)(*args, ranks, inv, aff)
            for q in (True, False)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][3], outs[1][3])


def test_update_pagerank_mesh_one_shot():
    init, n, batches, cap = _stream()
    jg = j_from_coo(init[:, 0], init[:, 1], n, edge_capacity=cap)
    tg = port_graph(jg)
    r0 = static_pagerank(tg).ranks
    live = np.stack([np_(tg.src), np_(tg.dst)], 1)[np_(tg.valid)]
    dele, ins = random_batch_update(live, n, 16, seed=6)
    ju = j_make_update(dele, ins, 32, 32)
    jg2 = j_apply_batch(jg, ju)
    tu = port_update(ju)
    tg2 = port_graph(jg2)
    plain = update_pagerank(tg, tg2, tu, r0, "frontier_prune")
    ref = j_update_pagerank(jg, jg2, ju, np_(r0), "frontier_prune",
                            mesh=JMesh(np.asarray(jax.devices()[:1]),
                                       ("model",)),
                            engine="kernel", pack_kw=dict(be=32, vb=16))
    for shards in (1, 2, 4):
        mesh = make_test_mesh(shards, device=CPU, model=shards)
        k = update_pagerank(tg, tg2, tu, r0, "frontier_prune", mesh=mesh,
                            engine="kernel", pack_kw=dict(be=32, vb=16))
        x = update_pagerank(tg, tg2, tu, r0, "frontier_prune", mesh=mesh)
        assert _linf(k.ranks, plain.ranks) <= 1e-6
        assert _linf(k.ranks, ref.ranks) <= 1e-6
        assert _linf(x.ranks, plain.ranks) <= 1e-6
        assert int(k.edges_processed) > 0 and int(k.vertices_processed) > 0
    with pytest.raises(ValueError, match="single-device structure"):
        update_pagerank(tg, tg2, tu, r0, "frontier_prune", mesh=mesh,
                        engine="kernel", packed=pack_graph(tg2, be=32,
                                                           vb=16))
    with pytest.raises(ValueError, match="no 'model' axis"):
        update_pagerank(tg, tg2, tu, r0, mesh=Mesh(
            np.asarray([torch.device("cpu")] * 2, dtype=object), ("data",)))


def test_elastic_rescale_four_shards_onto_two(tmp_path):
    """Serve on 4 shards to the middle of the stream, checkpoint (ranks,
    batch_idx), restore onto a 2-shard mesh (ranks bitwise, the partition
    the new mesh's) and serve the rest there: within the ladder's bound
    of the uninterrupted 4-shard stream."""
    init, n, batches, cap = _stream()
    four = make_test_mesh(4, device=CPU, model=4)
    two = make_test_mesh(4, device=CPU)               # 2 x 2: model 2
    full, snaps = _serve_port(four)
    split = 3

    def serve(mesh, upto, start=0, ranks=None):
        g = port_graph(j_from_coo(init[:, 0], init[:, 1], n,
                                  edge_capacity=cap))
        ingest = IngestQueue(flush_size=64, flush_interval=1e9, device=CPU)
        eng = ServeEngine(g, ingest, RankStore(), method="frontier_prune",
                          engine="kernel", mesh=mesh,
                          static_fallback_frac=1.0, kernel_opts=dict(PACK))
        if ranks is not None:
            # the feed is the log: replay its prefix into the graph
            eng.bootstrap()
            for b in batches[:start]:
                _feed(ingest, b, lambda q, k, u, v: q.submit(k, u, v))
                eng.step(force=True)
            eng._ranks = ranks
        else:
            eng.bootstrap()
        for b in batches[start:upto]:
            _feed(ingest, b, lambda q, k, u, v: q.submit(k, u, v))
            assert eng.step(force=True)
        return eng

    half = serve(four, split)
    saved = half.store.snapshot().ranks
    ck.save(str(tmp_path), split, dict(
        batch_idx=torch.tensor(split, dtype=torch.int64), ranks=saved))
    g = port_graph(j_from_coo(init[:, 0], init[:, 1], n, edge_capacity=cap))
    idx, ranks, part = rescale_pagerank_state(str(tmp_path), g, two,
                                              dtype=torch.float64)
    assert idx == split and torch.equal(ranks, saved)
    want = partition_graph(g, 2, 2)
    assert np.array_equal(part.src, want.src)
    assert np.array_equal(part.valid, want.valid)
    resumed = serve(two, len(batches), start=split, ranks=ranks)
    assert resumed._sharded.num_shards == 2
    assert _linf(resumed.store.snapshot().ranks, snaps[-1]) <= 1e-6
