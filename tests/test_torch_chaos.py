"""Port parity: the chaos harness (``serve/chaos.py``): schedule grammar,
the fault-injectable transport, the seeded end-to-end runs
(``tests/test_chaos.py``'s twins), then one seed and schedule through
both packages' harnesses: equal reports, bitwise replica parity in each,
writers' ranks within the serving contract's L∞ 1e-6.
"""
import dataclasses

import numpy as np
import pytest

import repro  # noqa: F401
from repro.serve import chaos as jchaos

from repro_torch.serve import FaultyTransport, LinkDown, LogicalClock, \
    parse_schedule
from repro_torch.serve.chaos import ChaosAction, ChaosHarness
from test_torch_common import CPU, np_

REPORT_FIELDS = ("events_fed", "generations", "failovers", "resyncs",
                 "parity_checks", "max_staleness", "degraded_spells",
                 "incidents", "transport")


# ---------------------------------------------------------------------------
# schedule grammar
# ---------------------------------------------------------------------------

def test_parse_schedule_grammar():
    spec = ("kill:r0@600+200; partition:r1@300+200;kill_writer@900;"
            "delay:r1@50+100")
    acts = parse_schedule(spec)
    assert acts == sorted(acts, key=lambda a: a.at)
    assert acts[0] == ChaosAction("delay", "r1", 50, 100)
    assert acts[1] == ChaosAction("partition", "r1", 300, 200)
    assert acts[2] == ChaosAction("kill", "r0", 600, 200)
    assert acts[3] == ChaosAction("kill_writer", None, 900, None)
    assert parse_schedule("") == []
    assert parse_schedule("kill:r0@5") == [ChaosAction("kill", "r0", 5,
                                                       None)]
    assert [tuple(a) for a in acts] == \
        [tuple(a) for a in jchaos.parse_schedule(spec)]


@pytest.mark.parametrize("bad,msg", [
    ("kill:r0", "missing '@offset'"),
    ("explode:r0@5", "unknown kind"),
    ("kill_writer:r0@5", "takes no target"),
    ("partition@5", "needs a target"),
])
def test_parse_schedule_rejects(bad, msg):
    with pytest.raises(ValueError, match=msg):
        parse_schedule(bad)


# ---------------------------------------------------------------------------
# transport semantics
# ---------------------------------------------------------------------------

def test_transport_delivery_order_and_delay():
    t = FaultyTransport(seed=0, delay=0.5)
    t.register("a")
    t.send("w", "a", "m1", now=0.0)
    t.send("w", "a", "m2", now=0.1)
    assert t.deliver("a", now=0.4) == []          # nothing due yet
    assert t.deliver("a", now=0.55) == ["m1"]
    assert t.deliver("a", now=1.0) == ["m2"]
    assert t.delivered == 2


def test_transport_partition_blocks_both_planes():
    t = FaultyTransport(seed=0)
    t.register("w")
    t.register("a")

    class W:
        name, alive = "w", True
    t.set_writer(W())
    t.partition("a")
    t.send("w", "a", "m", now=0.0)                # data plane: dropped
    assert t.dropped == 1
    assert t.deliver("a", now=1.0) == []
    with pytest.raises(LinkDown):                 # control plane: raises
        t.writer_for("a")
    t.heal("a")
    assert t.writer_for("a") is not None
    t.send("w", "a", "m2", now=0.0)
    assert t.deliver("a", now=1.0) == ["m2"]


def test_transport_kill_loses_inbox():
    t = FaultyTransport(seed=0)
    t.register("a")
    t.send("w", "a", "m", now=0.0)
    t.kill("a")                                   # process death
    assert t.deliver("a", now=1.0) == []
    t.revive("a")
    assert t.deliver("a", now=1.0) == []          # the inbox is gone


def test_transport_duplicate_and_drop_counters():
    t = FaultyTransport(seed=1, dup_p=1.0)
    t.register("a")
    t.send("w", "a", "m", now=0.0)
    assert t.duplicated == 1
    assert len(t.deliver("a", now=1.0)) == 2
    t2 = FaultyTransport(seed=1, drop_p=1.0)
    t2.register("a")
    t2.send("w", "a", "m", now=0.0)
    assert t2.dropped == 1 and t2.deliver("a", now=1.0) == []


def _counters(mod, seed):
    t = mod.FaultyTransport(seed=seed, drop_p=0.3, dup_p=0.2, reorder_p=0.3)
    t.register("a")
    for i in range(200):
        t.send("w", "a", i, now=i * 0.01)
    got = t.deliver("a", now=100.0)
    return (t.dropped, t.duplicated, t.reordered, tuple(got))


def test_transport_seeded_faults_are_deterministic():
    import repro_torch.serve.chaos as tchaos
    assert _counters(tchaos, 7) == _counters(tchaos, 7)
    assert _counters(tchaos, 7) != _counters(tchaos, 8)
    # the reference's draws, in its order: the same faults
    assert _counters(tchaos, 7) == _counters(jchaos, 7)


# ---------------------------------------------------------------------------
# end-to-end chaos runs (the harness asserts parity internally)
# ---------------------------------------------------------------------------

def test_clean_run_reaches_parity():
    h = ChaosHarness(num_replicas=2, events=160, scale=7, seed=3,
                     device=CPU)
    rep = h.run()
    assert rep.parity_checks >= 1
    assert rep.parity_max_linf <= 1e-6
    assert rep.failovers == 0 and rep.generations > 0


def test_chaos_run_recovers_from_kill_partition_and_failover():
    h = ChaosHarness(
        num_replicas=2, events=320, scale=7, seed=7, drop_p=0.05,
        schedule="partition:r1@80+60;kill:r0@160+60;kill_writer@260",
        staleness_slo_events=64, device=CPU)
    rep = h.run()
    assert rep.parity_checks >= 3          # heal, restart, failover, end
    assert rep.parity_max_linf <= 1e-6
    assert rep.failovers == 1
    assert h.writer.epoch == 1
    assert rep.resyncs >= 1
    assert rep.incidents["writer_failover"] == 1
    assert rep.incidents.get("replica_resync", 0) >= 1
    assert rep.generations > 0
    assert rep.events_fed == 320
    assert rep.transport["dropped"] > 0


def test_chaos_run_is_seed_deterministic():
    def run(seed):
        h = ChaosHarness(num_replicas=1, events=160, scale=7, seed=seed,
                         drop_p=0.1, schedule="partition:r0@40+40",
                         device=CPU)
        rep = h.run()
        return (rep.generations, rep.resyncs, rep.parity_checks,
                np_(h.writer.engine.store.snapshot().ranks))
    g1, r1, p1, ranks1 = run(11)
    g2, r2, p2, ranks2 = run(11)
    assert (g1, r1, p1) == (g2, r2, p2)
    np.testing.assert_array_equal(ranks1, ranks2)


# ---------------------------------------------------------------------------
# one seed and schedule through both packages
# ---------------------------------------------------------------------------

def _both(ckpt=None, **kw):
    t = ChaosHarness(device=CPU, **kw,
                     **({} if ckpt is None else dict(ckpt_dir=ckpt[0])))
    j = jchaos.ChaosHarness(**kw,
                            **({} if ckpt is None else dict(ckpt_dir=ckpt[1])))
    return t, t.run(), j, j.run()


def _assert_reports_equal(t, tr, j, jr):
    for f in REPORT_FIELDS:
        assert getattr(tr, f) == getattr(jr, f), f
    assert tr.parity_max_linf == jr.parity_max_linf == 0.0
    assert tr.lines()[0] == jr.lines()[0]
    wt = np_(t.writer.engine.store.snapshot().ranks)
    wj = np.asarray(j.writer.engine.store.snapshot().ranks)
    assert float(np.max(np.abs(wt - wj))) <= 1e-6


@pytest.mark.parametrize("engine", ["xla", "kernel"])
def test_chaos_report_equals_reference(engine):
    kw = dict(num_replicas=2, events=320, scale=7, seed=7, drop_p=0.05,
              dup_p=0.05, reorder_p=0.05,
              schedule="partition:r1@80+60;kill:r0@160+60;kill_writer@260",
              staleness_slo_events=64, engine=engine)
    if engine == "kernel":
        kw["kernel_opts"] = dict(tune=False)
    t = ChaosHarness(device=CPU, **kw)
    tr = t.run()
    if engine == "kernel":
        kw["kernel_opts"] = dict(tune=False, use_kernel=False)
    j = jchaos.ChaosHarness(**kw)
    jr = j.run()
    _assert_reports_equal(t, tr, j, jr)
    assert tr.failovers == 1 and tr.transport["dropped"] > 0


def test_checkpoint_ahead_failover_equals_reference(tmp_path):
    """Every replica is partitioned when the writer dies, so promotion
    restores the last checkpoint and rebuilds the graph from the feed
    (``_graph_at``); both packages agree on the report, and the rebuilt
    graph's slots equal the reference's bit for bit."""
    kw = dict(num_replicas=1, events=200, scale=7, seed=5, ckpt_every=1,
              schedule="partition:r0@30+150;kill_writer@100",
              staleness_slo_events=1 << 20)
    t, tr, j, jr = _both(ckpt=(str(tmp_path / "t"), str(tmp_path / "j")),
                         **kw)
    _assert_reports_equal(t, tr, j, jr)
    assert tr.failovers == 1
    msgs = [i.message for i in t.controller.incidents]
    assert any("promoted checkpoint" in m for m in msgs), msgs
    for seq in (-1, 57, 150):
        a, b = t._graph_at(seq), j._graph_at(seq)
        for f in ("src", "dst", "valid"):
            x, y = np_(getattr(a, f)), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype and np.array_equal(x, y), (seq, f)
        assert int(a.num_edges) == int(b.num_edges)


def test_replicate_driver_matches_reference(capsys):
    from repro.launch import replicate as jdrv

    from repro_torch.launch import replicate as tdrv
    argv = ["--scale", "7", "--events", "320", "--seed", "7", "--drop",
            "0.05", "--staleness-slo", "64", "--quiet", "--schedule",
            "partition:r1@80+60;kill_writer@260"]
    assert tdrv.main(argv + ["--device", "cpu"]) == 0
    port = capsys.readouterr().out.splitlines()
    assert jdrv.main(argv) == 0
    ref = capsys.readouterr().out.splitlines()
    assert port == ref
    assert any(line.startswith("incident replica_resync") for line in port)
    assert port[-1].startswith("chaos run complete")


def test_harness_edges_argument_skips_the_draw():
    """A caller holding the harness's own R-MAT draw passes it in: the
    run is the same."""
    from repro_torch.graph.generators import rmat_edges
    kw = dict(num_replicas=1, events=100, scale=7, seed=2, device=CPU)
    a = ChaosHarness(**kw)
    b = ChaosHarness(edges=rmat_edges(7, 8, seed=2)[0], **kw)
    ra, rb = a.run(), b.run()
    assert dataclasses.asdict(ra) == dataclasses.asdict(rb)
