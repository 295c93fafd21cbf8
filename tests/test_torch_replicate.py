"""Port parity: the replication tier (``serve/replicate.py``): delta
streams, gap retry/backoff, anchor resync, late join, graceful
degradation and writer failover, as ``tests/test_replicate.py`` holds the
reference to them; then the wire format across the two packages.

Everything runs on the injected ``LogicalClock`` + ``FaultyTransport``.
Parity is bitwise (L∞ == 0): deltas carry the exact f64 values the writer
published.  Interop: a message of either package, wrapped in the other's
message type, applies in the other's replica, and the replica's ranks and
``graph_*`` leaves equal the same package's own replica bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro import ppr as jppr
from repro import serve as jserve
from repro.graph.generators import erdos_renyi_edges as j_er
from repro.graph.structure import from_coo as j_from_coo
from repro.serve import replicate as jrep

from repro_torch.ft.elastic import ReplicaRoster
from repro_torch.graph.generators import erdos_renyi_edges
from repro_torch.graph.structure import from_coo
from repro_torch.ppr import IndexConfig, build_walk_index
from repro_torch.serve import (FailoverController, FaultyTransport,
                               IngestQueue, LinkDown, LogicalClock,
                               QueryClient, RankStore, ReadReplica,
                               ReplicaDegradedError, ReplicaQueryClient,
                               ReplicationWriter, ServeEngine, ServeMetrics)
from repro_torch.serve import replicate as rep
from test_torch_common import CPU, np_

N = 64
DT = 0.01


def _graph(seed=0, m=300):
    edges, n = erdos_renyi_edges(N, m, seed=seed)
    return from_coo(edges[:, 0], edges[:, 1], n,
                    edge_capacity=len(edges) + 1024, device=CPU)


def _engine_factory(clock, ckpt_dir=None, ckpt_every=1, ppr_cfg=None):
    def make(graph, last_seq, generation):
        ingest = IngestQueue(flush_size=8, flush_interval=0.0,
                             max_pending=1 << 16,
                             start_seq=last_seq + 1, clock=clock,
                             device=CPU)
        store = (RankStore(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)
                 if ckpt_dir else RankStore())
        return ServeEngine(graph, ingest, store, metrics=ServeMetrics(),
                           method="frontier_prune", clock=clock,
                           ppr_index=ppr_cfg)
    return make


def _writer(clock, transport, roster, anchor_every=4, ckpt_dir=None,
            ppr_cfg=None, **writer_kw):
    factory = _engine_factory(clock, ckpt_dir=ckpt_dir, ppr_cfg=ppr_cfg)
    engine = factory(_graph(), last_seq=-1, generation=0)
    engine.bootstrap()
    w = ReplicationWriter(engine, transport, anchor_every=anchor_every,
                          clock=clock, **writer_kw)
    w.attach()
    transport.set_writer(w)
    w.heartbeat(roster)
    return w, factory


def _replica(name, clock, transport, roster, **kw):
    kw.setdefault("max_retries", 3)
    kw.setdefault("backoff_base", 2 * DT)
    kw.setdefault("slo_windows", ((1.0, 1.0),))
    kw.setdefault("slo_min_events", 4)
    return ReadReplica(name, transport, N, roster=roster, seed=0,
                       clock=clock, device=CPU, **kw)


def _feed(writer, events, clock, roster, replicas=(), seed=1,
          step_every=8, hb_every=4, record=None):
    rng = np.random.default_rng(seed)
    for i in range(events):
        clock.advance(DT)
        u, v = (int(x) for x in rng.integers(0, N, size=2))
        if u != v:
            writer.engine.ingest.submit_insert(u, v)
            if record is not None:
                record.append((u, v))
        if (i + 1) % step_every == 0:
            writer.engine.step(force=True)
        if (i + 1) % hb_every == 0:
            writer.heartbeat(roster)
        for r in replicas:
            r.pump()
    writer.engine.drain()


def _settle(writer, replicas, clock, roster, rounds=60):
    """Advance past every backoff and pump until nothing is in flight."""
    for _ in range(rounds):
        clock.advance(0.1)
        writer.heartbeat(roster)
        for r in replicas:
            r.pump()


def _assert_parity(writer, replica):
    wgen = writer.engine.store.generation
    assert replica.epoch == writer.epoch
    assert replica.generation == wgen, (replica.generation, wgen)
    wr = writer.engine.store.snapshot().ranks
    linf = float((replica.ranks - wr).abs().max())
    assert linf == 0.0, f"replica diverged: L∞={linf:.3e} at gen {wgen}"


# ---------------------------------------------------------------------------
# clean stream: exact replication + query surface
# ---------------------------------------------------------------------------

def test_delta_stream_reaches_bitwise_parity():
    clock = LogicalClock()
    transport = FaultyTransport(seed=0)
    roster = ReplicaRoster(heartbeat_timeout=1e9)
    w, _ = _writer(clock, transport, roster)
    r = _replica("r0", clock, transport, roster)
    assert r.bootstrap()
    _feed(w, 80, clock, roster, replicas=[r])
    _settle(w, [r], clock, roster)
    _assert_parity(w, r)
    assert r.deltas_applied > 0
    assert r.gaps_detected == 0 and r.resyncs == 1   # bootstrap only
    client = ReplicaQueryClient(r)
    wr = np_(w.engine.store.snapshot().ranks)
    res = client.get_ranks([3, 1, 4])
    np.testing.assert_array_equal(res.ranks, wr[[3, 1, 4]])
    assert res.staleness_events == 0
    top = client.top_k(5)
    np.testing.assert_array_equal(np.asarray(top.ranks),
                                  np.sort(wr)[::-1][:5])
    # the writer's deltas are sparse: fewer indices than vertices
    assert 0 < max(w.delta_sizes) <= N


def test_replica_snapshots_never_change_after_publish():
    """A replica publishes a new rank tensor for every delta (clone, then
    scatter): a snapshot a reader holds keeps its values."""
    clock = LogicalClock()
    transport = FaultyTransport(seed=0)
    roster = ReplicaRoster(heartbeat_timeout=1e9)
    w, _ = _writer(clock, transport, roster)
    r = _replica("r0", clock, transport, roster)
    assert r.bootstrap()
    held = r.store.snapshot()
    kept = held.ranks.clone()
    _feed(w, 40, clock, roster, replicas=[r])
    _settle(w, [r], clock, roster)
    assert r.store.snapshot().generation > held.generation
    assert not torch.equal(r.store.snapshot().ranks, kept)
    assert torch.equal(held.ranks, kept)


def test_duplicates_and_reorder_are_idempotent():
    clock = LogicalClock()
    transport = FaultyTransport(seed=3, dup_p=0.4, reorder_p=0.5,
                                reorder_window=4 * DT)
    roster = ReplicaRoster(heartbeat_timeout=1e9)
    w, _ = _writer(clock, transport, roster)
    r = _replica("r0", clock, transport, roster)
    assert r.bootstrap()
    _feed(w, 120, clock, roster, replicas=[r])
    _settle(w, [r], clock, roster)
    _assert_parity(w, r)
    assert transport.duplicated > 0 and transport.reordered > 0
    assert r.duplicates > 0                # dups detected, applied once


# ---------------------------------------------------------------------------
# gap retry state machine
# ---------------------------------------------------------------------------

def test_dropped_deltas_recovered_by_retransmit():
    clock = LogicalClock()
    transport = FaultyTransport(seed=5, drop_p=0.3)
    roster = ReplicaRoster(heartbeat_timeout=1e9)
    w, _ = _writer(clock, transport, roster)
    r = _replica("r0", clock, transport, roster)
    assert r.bootstrap()
    _feed(w, 120, clock, roster, replicas=[r])
    _settle(w, [r], clock, roster)
    _assert_parity(w, r)
    assert r.gaps_detected >= 1
    assert r.retries_sent >= 1
    assert w.retransmits >= 1


def test_gap_beyond_log_forces_anchor_resync():
    clock = LogicalClock()
    transport = FaultyTransport(seed=0)
    roster = ReplicaRoster(heartbeat_timeout=1e9)
    w, _ = _writer(clock, transport, roster, anchor_every=2,
                   log_capacity=2)
    r = _replica("r0", clock, transport, roster)
    assert r.bootstrap()
    _feed(w, 40, clock, roster, replicas=[r])
    transport.partition("r0")
    _feed(w, 80, clock, roster, replicas=[r])
    transport.heal("r0")
    _settle(w, [r], clock, roster)
    _assert_parity(w, r)
    assert r.resyncs >= 2                  # bootstrap + post-partition
    assert "replica_resync" in [i.kind for i in r.incidents]


def test_late_joiner_bootstraps_from_anchor_and_tail():
    clock = LogicalClock()
    transport = FaultyTransport(seed=0)
    roster = ReplicaRoster(heartbeat_timeout=1e9)
    w, _ = _writer(clock, transport, roster, anchor_every=8)
    _feed(w, 60, clock, roster)
    late = _replica("late", clock, transport, roster)
    assert late.bootstrap()                # anchor + replayed delta tail
    _assert_parity(w, late)


def test_unreachable_writer_fails_bootstrap_gracefully():
    clock = LogicalClock()
    transport = FaultyTransport(seed=0)
    roster = ReplicaRoster(heartbeat_timeout=1e9)
    w, _ = _writer(clock, transport, roster)
    w.kill()
    r = _replica("r0", clock, transport, roster)
    assert not r.bootstrap()               # False, not an exception
    with pytest.raises(LinkDown):
        transport.writer_for("r0")


# ---------------------------------------------------------------------------
# graceful degradation ladder
# ---------------------------------------------------------------------------

def test_degraded_replica_sheds_topk_but_serves_points():
    clock = LogicalClock()
    transport = FaultyTransport(seed=0)
    roster = ReplicaRoster(heartbeat_timeout=1e9)
    w, _ = _writer(clock, transport, roster)
    r = _replica("r0", clock, transport, roster, staleness_slo_events=4)
    assert r.bootstrap()
    _feed(w, 40, clock, roster, replicas=[r])
    _settle(w, [r], clock, roster)
    assert not r.degraded
    transport.drop_p = 1.0                 # blackhole the stream
    _feed(w, 40, clock, roster, replicas=[r])
    transport.drop_p = 0.0
    clock.advance(DT)
    w.heartbeat(roster)
    r.pump()
    assert r.degraded and r.staleness > 4
    client = ReplicaQueryClient(r)
    res = client.get_ranks([0, 1])         # the ladder's floor holds
    assert res.staleness_events == r.staleness
    with pytest.raises(ReplicaDegradedError) as e:
        client.top_k(3)
    assert e.value.staleness_events == r.staleness
    with pytest.raises(ReplicaDegradedError):
        client.personalized_top_k([1], 3)
    assert "replica_degraded" in [i.kind for i in r.incidents]
    _settle(w, [r], clock, roster)
    assert not r.degraded
    _assert_parity(w, r)
    assert "replica_recovered" in [i.kind for i in r.incidents]
    client.top_k(3)                        # shedding is over


def test_shed_disabled_keeps_answering_stale_topk():
    clock = LogicalClock()
    transport = FaultyTransport(seed=0)
    roster = ReplicaRoster(heartbeat_timeout=1e9)
    w, _ = _writer(clock, transport, roster)
    r = _replica("r0", clock, transport, roster, staleness_slo_events=4,
                 shed_on_degrade=False)
    assert r.bootstrap()
    transport.drop_p = 1.0
    _feed(w, 40, clock, roster, replicas=[r])
    transport.drop_p = 0.0
    clock.advance(DT)
    w.heartbeat(roster)
    r.pump()
    assert r.degraded
    res = ReplicaQueryClient(r).top_k(3)   # stale but answered
    assert res.staleness_events == r.staleness > 4


# ---------------------------------------------------------------------------
# heartbeat failover
# ---------------------------------------------------------------------------

def test_failover_promotes_freshest_replica_without_losing_generation():
    clock = LogicalClock()
    transport = FaultyTransport(seed=0)
    roster = ReplicaRoster(heartbeat_timeout=0.5)
    w, factory = _writer(clock, transport, roster)
    r0 = _replica("r0", clock, transport, roster)
    r1 = _replica("r1", clock, transport, roster)
    assert r0.bootstrap() and r1.bootstrap()
    _feed(w, 40, clock, roster, replicas=[r0, r1])
    transport.partition("r0")
    _feed(w, 40, clock, roster, replicas=[r0, r1])
    transport.heal("r0")
    r1.pump()
    committed_gen = w.engine.store.generation
    committed_seq = w.engine.ingest.latest_seq
    w.kill()
    clock.advance(1.0)                     # writer heartbeat lapses...
    r0.pump()
    r1.pump()                              # ...the replicas keep beating
    ctl = FailoverController(transport, roster, factory,
                             num_vertices=N, clock=clock, device=CPU)
    promoted = ctl.check(w, [r0, r1])
    assert promoted is not None
    new_w, promoted_replica = promoted
    assert promoted_replica is r1          # freshest by (gen, last_seq)
    assert new_w.epoch == w.epoch + 1
    assert new_w.engine.store.generation >= committed_gen
    assert new_w.engine.ingest.start_seq > \
        new_w.engine.store.snapshot().last_seq
    transport.unregister(r1.name)
    transport.set_writer(new_w)
    assert ctl.failovers == 1 and len(ctl.failover_ms) == 1
    assert "writer_failover" in [i.kind for i in ctl.incidents]
    _feed(new_w, 40, clock, roster, replicas=[r0], seed=9)
    _settle(new_w, [r0], clock, roster)
    assert r0.epoch == new_w.epoch
    _assert_parity(new_w, r0)
    assert new_w.engine.ingest.latest_seq >= committed_seq


def _assert_ppr_parity(writer, replica):
    """Writer and replica hold the same walks (bitwise) and answer
    index-mode personalized top-k identically."""
    widx = writer.engine.store.snapshot().ppr_index
    assert widx is not None and replica.ppr is not None
    assert torch.equal(replica.ppr.steps, widx.steps)
    wq = QueryClient(writer.engine.store, writer.engine.ingest)
    rq = ReplicaQueryClient(replica)
    for seeds in ([1], [5, 9]):
        a = rq.personalized_top_k(seeds, 5, mode="index")
        b = wq.personalized_top_k(seeds, 5, mode="index")
        assert a.vertices.tolist() == b.vertices.tolist()
        np.testing.assert_array_equal(np.asarray(a.ranks),
                                      np.asarray(b.ranks))


def test_ppr_chaos_heals_keep_bitwise_index_parity(monkeypatch):
    """Walk-index parity through dropped deltas (retransmit), a partition
    past the log (anchor resync, healed by repair) and writer death
    (failover adopts the replica's index): no ``build_walk_index`` call
    after bootstrap on either side."""
    clock = LogicalClock()
    transport = FaultyTransport(seed=5)
    roster = ReplicaRoster(heartbeat_timeout=0.5)
    cfg = IndexConfig(num_walks=8, max_len=8, seed=5)
    factory = _engine_factory(clock, ppr_cfg=cfg)
    engine = factory(_graph(), last_seq=-1, generation=0)
    engine.bootstrap()
    w = ReplicationWriter(engine, transport, anchor_every=2,
                          log_capacity=2, clock=clock)
    w.attach()
    transport.set_writer(w)
    w.heartbeat(roster)
    r = _replica("r0", clock, transport, roster, ppr_cfg=cfg)
    assert r.bootstrap()                   # builds the replica index once
    _assert_ppr_parity(w, r)

    builds = []
    import repro_torch.serve.engine as eng_mod
    for mod in (eng_mod, rep):
        orig = mod.build_walk_index
        monkeypatch.setattr(
            mod, "build_walk_index",
            lambda *a, _o=orig, **k: (builds.append(1), _o(*a, **k))[1])

    transport.drop_p = 0.3                 # heal 1: retransmit
    _feed(w, 40, clock, roster, replicas=[r], seed=2)
    transport.drop_p = 0.0
    _settle(w, [r], clock, roster)
    _assert_parity(w, r)
    _assert_ppr_parity(w, r)

    transport.partition("r0")              # heal 2: anchor resync
    _feed(w, 40, clock, roster, replicas=[r], seed=3)
    transport.heal("r0")
    _settle(w, [r], clock, roster)
    assert r.resyncs >= 2 and r.heals_by_repair >= 1
    _assert_parity(w, r)
    _assert_ppr_parity(w, r)
    assert builds == []                    # resynced by repair

    committed_gen = w.engine.store.generation
    w.kill()                               # heal 3: failover
    clock.advance(1.0)
    r.pump()
    ctl = FailoverController(transport, roster, factory,
                             num_vertices=N, clock=clock, device=CPU)
    new_w, promoted = ctl.check(w, [r])
    assert promoted is r
    assert new_w.engine.store.generation >= committed_gen
    assert builds == []                    # index carried over
    snap = new_w.engine.store.snapshot()
    assert torch.equal(snap.ppr_index.steps,
                       build_walk_index(snap.graph, cfg).steps)
    transport.set_writer(new_w)
    _feed(new_w, 24, clock, roster, seed=11)
    snap = new_w.engine.store.snapshot()
    assert torch.equal(snap.ppr_index.steps,
                       build_walk_index(snap.graph, cfg).steps)
    assert builds == []


def test_failover_restores_checkpoint_when_replicas_lag(tmp_path):
    clock = LogicalClock()
    transport = FaultyTransport(seed=0)
    roster = ReplicaRoster(heartbeat_timeout=0.5)
    feed_log: list = []
    w, factory = _writer(clock, transport, roster, ckpt_dir=str(tmp_path))
    base_graph = w.engine.store.snapshot().graph

    def rebuild_graph(last_seq):
        """The recorded feed is the graph's log (insert-only here)."""
        src = base_graph.src.numpy().copy()
        dst = base_graph.dst.numpy().copy()
        valid = base_graph.valid.numpy().copy()
        ne = int(base_graph.num_edges)
        live = set(zip(src[:ne][valid[:ne]].tolist(),
                       dst[:ne][valid[:ne]].tolist()))
        for u, v in feed_log[: last_seq + 1]:
            if (u, v) not in live:
                src[ne], dst[ne], valid[ne] = u, v, True
                live.add((u, v))
                ne += 1
        return dataclasses.replace(
            base_graph, src=torch.from_numpy(src),
            dst=torch.from_numpy(dst), valid=torch.from_numpy(valid),
            num_edges=torch.tensor(ne, dtype=torch.int32))

    r0 = _replica("r0", clock, transport, roster)
    assert r0.bootstrap()
    transport.partition("r0")              # behind for the whole stream
    _feed(w, 40, clock, roster, replicas=[r0], record=feed_log)
    committed_gen = w.engine.store.generation
    committed_seq = int(w.engine.store.snapshot().last_seq)
    assert committed_gen > 0
    w.kill()
    clock.advance(1.0)
    bare = FailoverController(transport, roster, factory,
                              ckpt_dir=str(tmp_path), num_vertices=N,
                              rebuild_graph=None, clock=clock, device=CPU)
    with pytest.raises(RuntimeError, match="refusing"):
        bare.promote(w, [r0])
    ctl = FailoverController(transport, roster, factory,
                             ckpt_dir=str(tmp_path), num_vertices=N,
                             rebuild_graph=rebuild_graph, clock=clock,
                             device=CPU)
    new_w, promoted_replica = ctl.promote(w, [r0])
    assert promoted_replica is None        # came from the checkpoint
    assert new_w.engine.store.generation == committed_gen
    assert int(new_w.engine.store.snapshot().last_seq) == committed_seq
    transport.set_writer(new_w)
    transport.heal("r0")
    _settle(new_w, [r0], clock, roster)
    assert r0.epoch == new_w.epoch == w.epoch + 1
    _assert_parity(new_w, r0)


# ---------------------------------------------------------------------------
# the wire across packages
# ---------------------------------------------------------------------------

class _Recording:
    """Wraps a transport: every broadcast message is also kept."""

    def __init__(self, inner):
        self.inner, self.sent = inner, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def broadcast(self, src, msg, now):
        self.sent.append(msg)
        self.inner.broadcast(src, msg, now)


def _graph_leaves(g):
    return [np_(g.src), np_(g.dst), np_(g.valid)]


def _assert_replicas_equal(a, b):
    assert (a.generation, a.applied_seq, a.last_seq) == \
        (b.generation, b.applied_seq, b.last_seq)
    ra, rb = np_(a.ranks), np_(b.ranks)
    assert ra.dtype == rb.dtype == np.float64
    assert np.array_equal(ra.view(np.int64), rb.view(np.int64))
    for x, y in zip(_graph_leaves(a.graph), _graph_leaves(b.graph)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    # the reference's apply_batch widens num_edges to int64 under x64
    assert int(a.graph.num_edges) == int(b.graph.num_edges)


def _jfeed(engine, steps, seed):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        for _ in range(8):
            u, v = (int(x) for x in rng.integers(0, N, size=2))
            if u == v:
                continue
            if rng.random() < 0.2:
                engine.ingest.submit_delete(u, v)
            else:
                engine.ingest.submit_insert(u, v)
        engine.step(force=True)


def _reference_writer(ppr_cfg=None, anchor_every=3):
    clock = jserve.LogicalClock()
    transport = _Recording(jserve.FaultyTransport(seed=0))
    edges, n = j_er(N, 300, seed=0)
    g = j_from_coo(edges[:, 0], edges[:, 1], n,
                   edge_capacity=len(edges) + 1024)
    ingest = jserve.IngestQueue(flush_size=8, flush_interval=0.0,
                                max_pending=1 << 16, clock=clock)
    eng = jserve.ServeEngine(g, ingest, jserve.RankStore(),
                             method="frontier_prune", clock=clock,
                             ppr_index=ppr_cfg)
    eng.bootstrap()
    w = jrep.ReplicationWriter(eng, transport, anchor_every=anchor_every,
                               clock=clock)
    w.attach()
    transport.set_writer(w)
    return w, transport, clock


def _port_writer(anchor_every=3):
    clock = LogicalClock()
    transport = _Recording(FaultyTransport(seed=0))
    factory = _engine_factory(clock)
    eng = factory(from_coo(*_er_edges(), N, edge_capacity=_er_cap(),
                           device=CPU), last_seq=-1, generation=0)
    eng.bootstrap()
    w = ReplicationWriter(eng, transport, anchor_every=anchor_every,
                          clock=clock)
    w.attach()
    transport.set_writer(w)
    return w, transport, clock


def _er_edges():
    edges, _ = erdos_renyi_edges(N, 300, seed=0)
    return edges[:, 0], edges[:, 1]


def _er_cap():
    return len(_er_edges()[0]) + 1024


@pytest.mark.parametrize("with_ppr", [False, True])
def test_reference_messages_apply_in_the_port(with_ppr):
    """The reference writer's anchor and deltas, wrapped in the port's
    message types, give a port replica the reference replica's ranks and
    graph bit for bit (with a walk index: the writer's walks)."""
    jcfg = jppr.IndexConfig(num_walks=4, max_len=6, seed=3) \
        if with_ppr else None
    tcfg = IndexConfig(num_walks=4, max_len=6, seed=3) if with_ppr else None
    w, transport, clock = _reference_writer(ppr_cfg=jcfg)
    jr = jrep.ReadReplica("jr", transport.inner, N, ppr_cfg=jcfg,
                          clock=clock)
    tr = ReadReplica("tr", FaultyTransport(), N, ppr_cfg=tcfg, device=CPU)
    anchor = w.newest_anchor()
    jr._load_anchor(anchor)
    tr._load_anchor(rep.AnchorMsg(*anchor))
    _assert_replicas_equal(tr, jr)
    _jfeed(w.engine, 7, seed=4)
    deltas = [m for m in transport.sent if isinstance(m, jrep.DeltaMsg)]
    assert len(deltas) == 7
    for msg in deltas:
        assert msg.rank_idx.dtype == np.int64
        assert msg.rank_val.dtype == np.float64
        jr._on_delta(msg)
        tr._on_delta(rep.DeltaMsg(*msg))
        _assert_replicas_equal(tr, jr)
    wr = np.asarray(w.engine.store.snapshot().ranks)
    assert np.array_equal(np_(tr.ranks), wr)
    # a late port replica from the newest anchor (gen 6) and the tail
    late = ReadReplica("late", FaultyTransport(), N, ppr_cfg=tcfg,
                       device=CPU)
    anchor = w.newest_anchor()
    assert anchor.generation == 6
    late._load_anchor(rep.AnchorMsg(*anchor))
    for msg in w.delta_tail(anchor.seq):
        late._on_delta(rep.DeltaMsg(*msg))
    _assert_replicas_equal(late, jr)
    if with_ppr:
        widx = w.engine.store.snapshot().ppr_index
        assert rep._ppr_identity(tr.ppr) == jrep._ppr_identity(widx)
        assert np.array_equal(np_(tr.ppr.steps), np.asarray(widx.steps))
        assert np.array_equal(np_(late.ppr.steps), np.asarray(widx.steps))


def test_port_messages_apply_in_the_reference():
    """The port writer's anchor and deltas (the device diff, the stacked
    anchor copy), wrapped in the reference's message types, give a
    reference replica the port replica's ranks and graph bit for bit."""
    w, transport, clock = _port_writer()
    tr = ReadReplica("tr", transport.inner, N, device=CPU, clock=clock)
    jr = jrep.ReadReplica("jr", jserve.FaultyTransport(), N)
    anchor = w.newest_anchor()
    assert anchor.state["ranks"].dtype == np.float64
    assert anchor.state["graph_num_edges"].shape == ()
    assert anchor.state["graph_valid"].dtype == np.bool_
    tr._load_anchor(anchor)
    jr._load_anchor(jrep.AnchorMsg(*anchor))
    _assert_replicas_equal(jr, tr)
    _jfeed(w.engine, 7, seed=5)
    deltas = [m for m in transport.sent if isinstance(m, rep.DeltaMsg)]
    assert len(deltas) == 7
    for msg in deltas:
        assert msg.rank_idx.dtype == np.int64
        assert msg.rank_val.dtype == np.float64
        for f, a in msg.update.items():
            assert a.dtype == (np.bool_ if f.endswith("mask") else np.int32)
        tr._on_delta(msg)
        jr._on_delta(jrep.DeltaMsg(*msg))
        _assert_replicas_equal(jr, tr)
    assert np.array_equal(np.asarray(jr.ranks),
                          np_(w.engine.store.snapshot().ranks))
    anchor = w.newest_anchor()
    assert anchor.generation == 6
    late = jrep.ReadReplica("late", jserve.FaultyTransport(), N)
    late._load_anchor(jrep.AnchorMsg(*anchor))
    for msg in w.delta_tail(anchor.seq):
        late._on_delta(jrep.DeltaMsg(*msg))
    _assert_replicas_equal(late, tr)


def test_delta_diff_semantics_nan_and_signed_zero():
    """The device diff keeps NumPy's ``!=``: a NaN always differs, -0.0
    equals 0.0; only the changed indices and their values ship."""
    clock = LogicalClock()
    transport = _Recording(FaultyTransport(seed=0))
    w, _ = _writer(clock, transport, ReplicaRoster(heartbeat_timeout=1e9))
    snap = w.engine.store.snapshot()
    prev = snap.ranks.clone()
    prev[0], prev[1], prev[2] = float("nan"), 0.0, 0.0
    w._prev = prev
    new = prev.clone()
    new[1] = -0.0                          # equal
    new[3] = prev[3] * 2                   # differs
    w.engine.ingest.submit_insert(1, 2)
    batch = w.engine.ingest.poll(force=True)
    w._on_publish(snap._replace(ranks=new, generation=1), batch)
    msg = transport.sent[-1]
    assert msg.rank_idx.tolist() == [0, 3]
    assert np.isnan(msg.rank_val[0]) and msg.rank_val[1] == new[3].item()
    want = np.flatnonzero(np_(new) != np_(prev))
    assert msg.rank_idx.tolist() == want.tolist()


def test_edge_diff_touched_equals_reference():
    jg0 = j_from_coo(*j_er(N, 300, seed=1)[0].T, N, edge_capacity=400)
    jg1 = j_from_coo(*j_er(N, 300, seed=2)[0].T, N, edge_capacity=400)
    tg0, tg1 = (from_coo(np_(g.src)[:int(g.num_edges)],
                         np_(g.dst)[:int(g.num_edges)], N,
                         edge_capacity=400, device=CPU) for g in (jg0, jg1))
    want = np.asarray(jrep._edge_diff_touched(jg0, jg1, N))
    got = rep._edge_diff_touched(tg0, tg1, N)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    assert not rep._edge_diff_touched(tg0, tg0, N).any()
    # slot 0 holds a changed edge whose src is 0: the miss lanes (also
    # sent to index 0) must not clear it
    assert want[0] == got[0]


def test_ppr_identity_equal_across_packages():
    jcfg = jppr.IndexConfig(num_walks=4, max_len=5, seed=11)
    tcfg = IndexConfig(num_walks=4, max_len=5, seed=11)
    edges, n = j_er(N, 200, seed=3)
    jidx = jppr.build_walk_index(j_from_coo(edges[:, 0], edges[:, 1], n),
                                 jcfg)
    tidx = build_walk_index(from_coo(edges[:, 0], edges[:, 1], n,
                                     device=CPU), tcfg)
    assert rep._ppr_identity(tidx) == jrep._ppr_identity(jidx)
    assert rep._ppr_identity(None) is None
