"""Correctness observability of the port (DESIGN.md §12) against
``repro.obs``: the rank digest bit for bit, invariant sentinels, sampled
shadow verification, flight-recorder capture → bit-for-bit replay on both
engines and with a walk index, SLO burn-rate arithmetic, the monitor's
one host sync a batch, export hardening, and bundles that cross between
the two packages.

Digests are compared only within one package: the two f64 engines agree
to ~1e-12, not bit for bit (ROADMAP queue 3), so a bundle replayed by the
other package matches every generation and decision, and its digests
are its own.
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables x64 for the reference)
import jax.numpy as jnp
from repro import obs as jobs
from repro.graph import generators as jgen
from repro.graph import structure as jstr
from repro.serve import IngestQueue as JIngest
from repro.serve import RankStore as JStore
from repro.serve import ServeEngine as JEngine

from repro_torch.core.pagerank import static_pagerank
from repro_torch.device import host_sync_count
from repro_torch.graph.structure import CACHE_BUILDS
from repro_torch.obs import (CorrectnessMonitor, JsonlSink, MetricsExporter,
                             MonitorConfig, ShadowVerifier, SloSet,
                             SloTracker, load_bundle, rank_digest, replay)
from repro_torch.obs.recorder import _PACKED_LEAVES
from repro_torch.obs.sentinel import InvariantSentinel, SentinelConfig
from repro_torch.serve import IngestQueue, RankStore, ServeEngine, \
    ServeMetrics
from test_torch_common import CPU, port_graph

N = 64


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _jgraph(seed=0, m=400, cap_extra=512):
    edges, n = jgen.erdos_renyi_edges(N, m, seed=seed)
    return jstr.from_coo(edges[:, 0], edges[:, 1], n,
                         edge_capacity=len(edges) + cap_extra)


def _graph(seed=0, m=400, cap_extra=512):
    return port_graph(_jgraph(seed, m, cap_extra))


def _service(graph, monitor=None, flush_size=4, **engine_kw):
    metrics = ServeMetrics()
    ingest = IngestQueue(flush_size=flush_size, flush_interval=0.0,
                         device=CPU)
    store = RankStore()
    engine = ServeEngine(graph, ingest, store, metrics=metrics,
                         method="frontier_prune", monitor=monitor,
                         **engine_kw)
    return ingest, store, engine, metrics


def _events(num_batches, flush_size=4, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_batches * flush_size):
        u, v = rng.integers(0, N, size=2)
        while u == v:
            u, v = rng.integers(0, N, size=2)
        out.append((int(u), int(v)))
    return out


def _feed(ingest, engine, num_batches, flush_size=4, seed=0):
    """Submit random insert events and drain them batch by batch."""
    for u, v in _events(num_batches, flush_size, seed):
        ingest.submit_insert(u, v)
    return engine.drain()


def _monitor(**over):
    kw = dict(shadow_every=0, anchor_every=4, recorder_capacity=64)
    kw.update(over)
    return CorrectnessMonitor(MonitorConfig(**kw))


# ---------------------------------------------------------------------------
# rank digest: the reference's bit for bit
# ---------------------------------------------------------------------------

def _digest_cases():
    rng = np.random.default_rng(11)
    r = rng.random(1000)
    neg0 = r.copy()
    neg0[[3, 500]] = -0.0
    sub = r.copy()
    sub[7] = np.nextafter(0.0, 1.0)                 # smallest subnormal
    sub[8] = 2.2250738585072014e-308 / 3            # another subnormal
    nan = r.copy()
    bits = nan.view(np.int64)
    bits[[0, 9]] = np.int64(0x7FF8000000000001)     # quiet NaN, payload 1
    bits[10] = np.int64(-0x0008000000000000)        # negative quiet NaN
    big = np.full(4096, 1e308)                      # products wrap
    return dict(random=r, negzero=neg0, subnormal=sub, nan=nan, wrap=big,
                one=np.array([0.25]))


@pytest.mark.parametrize("case", list(_digest_cases()))
def test_rank_digest_matches_reference_bit_for_bit(case):
    r = _digest_cases()[case]
    want = jobs.rank_digest(jnp.asarray(r))
    got = rank_digest(torch.from_numpy(r.copy()))
    assert got == want
    # the wrap is two's complement mod 2^64 (held against Python ints)
    bits = r.view(np.int64).astype(object)
    exact = sum(int(b) * (2 * i + 1) for i, b in enumerate(bits))
    exact = (exact + 2**63) % 2**64 - 2**63
    assert got == exact


def test_rank_digest_is_bit_sensitive():
    r = static_pagerank(_graph()).ranks
    d0 = rank_digest(r)
    assert rank_digest(r.clone()) == d0
    bumped = r.clone()
    bumped[7] = float(np.nextafter(float(r[7]), 1.0))
    assert rank_digest(bumped) != d0
    swapped = r.clone()
    swapped[[0, 1]] = swapped[[1, 0]]
    assert rank_digest(swapped) != d0


# ---------------------------------------------------------------------------
# invariant sentinel
# ---------------------------------------------------------------------------

def _good_ranks():
    return torch.full((8,), 1.0 / 8, dtype=torch.float64)


def _observe(sent, ranks, delta=1e-12, iterations=5, affected=10,
             fallback=False, gen=1):
    return sent.observe(generation=gen, last_seq=gen, ranks=ranks,
                        delta=delta, iterations=iterations,
                        affected=affected, fallback=fallback)


def test_sentinel_clean_batch_no_incidents():
    sent = InvariantSentinel(clock=FakeClock())
    digest, incs = _observe(sent, _good_ranks())
    assert incs == []
    assert digest == rank_digest(_good_ranks())
    assert sent.gauges["sentinel_rank_mass_err"] < 1e-12
    assert sent.gauges["sentinel_trips"] == 0.0


def _times3(r):
    r = r.clone()
    r[0] *= 3.0
    return r


def _negate(r):
    r = r.clone()
    r[1] += 2 * r[0]
    r[0] = -r[0]
    return r


def _nan(r):
    r = r.clone()
    r[0] = float("nan")
    return r


@pytest.mark.parametrize("mutate,kind", [
    (_times3, "rank_mass"), (_negate, "rank_negative"),
    (_nan, "rank_nonfinite")])
def test_sentinel_trips_on_invariant_violation(mutate, kind):
    sent = InvariantSentinel(clock=FakeClock())
    jsent = jobs.InvariantSentinel(clock=FakeClock())
    _, incs = _observe(sent, mutate(_good_ranks()))
    _, jincs = _observe(jsent, jnp.asarray(mutate(_good_ranks()).numpy()))
    assert [i.kind for i in incs] == [kind] == [i.kind for i in jincs]
    assert incs[0].severity == "error"
    assert incs[0].generation == 1
    d = incs[0].as_dict()
    json.dumps(d)
    assert d == jincs[0].as_dict() or d["kind"] == kind


def test_sentinel_trips_on_unconverged_residual():
    sent = InvariantSentinel(SentinelConfig(residual_tol=1e-6),
                             clock=FakeClock())
    _, incs = _observe(sent, _good_ranks(), delta=1e-3)
    assert [i.kind for i in incs] == ["residual"]
    # a 0-d tensor delta rides the sentinel's one read
    before = host_sync_count()
    _, incs = _observe(sent, _good_ranks(),
                       delta=torch.tensor(1e-3, dtype=torch.float64))
    assert host_sync_count() == before + 1
    assert [i.kind for i in incs] == ["residual"]
    assert sent.gauges["sentinel_residual"] == 1e-3


def test_sentinel_anomaly_scores_after_warmup():
    cfg = SentinelConfig(anomaly_warmup=8, anomaly_z=6.0)
    sent = InvariantSentinel(cfg, clock=FakeClock())
    for i in range(12):
        _, incs = _observe(sent, _good_ranks(), iterations=5,
                           affected=10, gen=i)
        assert incs == []
    _, incs = _observe(sent, _good_ranks(), iterations=500,
                       affected=100000, gen=99)
    assert {i.kind for i in incs} == {"anomaly_iterations",
                                      "anomaly_affected"}
    assert all(i.severity == "warn" for i in incs)


def test_sentinel_fallback_batches_skip_anomaly_scoring():
    cfg = SentinelConfig(anomaly_warmup=2, anomaly_z=6.0)
    sent = InvariantSentinel(cfg, clock=FakeClock())
    for i in range(6):
        _observe(sent, _good_ranks(), iterations=5, gen=i)
    _, incs = _observe(sent, _good_ranks(), iterations=10000,
                       affected=10**6, fallback=True, gen=7)
    assert incs == []
    assert sent.gauges["sentinel_anomaly_iterations_z"] == 0.0


# ---------------------------------------------------------------------------
# shadow verification
# ---------------------------------------------------------------------------

def test_shadow_sampling_cadence_and_clean_reports():
    g = _graph()
    ranks = static_pagerank(g).ranks
    sv = ShadowVerifier(every=4, background=False)
    taken = [sv.maybe_submit(i, i, g, ranks) for i in range(9)]
    assert taken == [True, False, False, False] * 2 + [True]
    assert sv.samples == 3
    assert sv.take_incidents() == []
    assert all(r.l1 < 1e-8 for r in sv.reports)
    assert sv.gauges()["shadow_samples"] == 3.0


def test_shadow_builds_its_own_order():
    g = _graph()
    ranks = static_pagerank(g).ranks
    built = CACHE_BUILDS["pull_order"]
    sv = ShadowVerifier(every=1, background=False)
    sv.maybe_submit(0, 0, g, ranks)
    sv.maybe_submit(1, 1, g, ranks)
    # one order a sample, on its own clones; the snapshot's stays cached
    assert CACHE_BUILDS["pull_order"] == built + 2
    g.pull_order()
    assert CACHE_BUILDS["pull_order"] == built + 2


def test_shadow_flags_divergent_snapshot():
    g = _graph()
    ranks = static_pagerank(g).ranks.clone()
    ranks[0] *= 2.0
    sv = ShadowVerifier(every=1, background=False)
    sv.maybe_submit(5, 42, g, ranks)
    incs = sv.take_incidents()
    assert {i.kind for i in incs} == {"shadow_l1", "shadow_linf"}
    assert all(i.generation == 5 and i.last_seq == 42 for i in incs)
    assert sv.take_incidents() == []


def test_shadow_background_latest_wins():
    g = _graph()
    ranks = static_pagerank(g).ranks
    sv = ShadowVerifier(every=1, background=True)
    gate = threading.Event()
    orig = sv._verify

    def slow_verify(job):
        assert gate.wait(10.0)
        return orig(job)

    sv._verify = slow_verify
    try:
        sv.maybe_submit(0, 0, g, ranks)
        deadline = time.time() + 10.0
        while not sv._busy and time.time() < deadline:
            time.sleep(0.001)
        assert sv._busy
        sv.maybe_submit(1, 1, g, ranks)
        sv.maybe_submit(2, 2, g, ranks)              # displaces gen 1
        gate.set()
        assert sv.flush(timeout=10.0)
    finally:
        gate.set()
        sv.stop()
    assert sv.samples == 2
    assert sv.skipped == 1
    assert [r.generation for r in sv.reports] == [0, 2]
    assert all(r.l1 < 1e-8 for r in sv.reports)


# ---------------------------------------------------------------------------
# SLO burn rates (host-only copy of the reference)
# ---------------------------------------------------------------------------

def test_slo_burn_rate_arithmetic():
    clk = FakeClock()
    t = SloTracker("latency", objective=0.9, windows=((120.0, 2.0),),
                   min_events=4, clock=clk)
    jt = jobs.SloTracker("latency", objective=0.9, windows=((120.0, 2.0),),
                         min_events=4, clock=clk)
    for i in range(10):
        clk.t = float(i)
        t.record(good=(i % 2 == 0))
        jt.record(good=(i % 2 == 0))
    assert t.counts(120.0) == (10, 5)
    assert t.burn_rate(120.0) == pytest.approx(5.0)
    alerts = t.evaluate()
    assert [tuple(a) for a in alerts] == [tuple(a) for a in jt.evaluate()]
    a = alerts[0]
    assert a.long_window_s == 120.0 and a.short_window_s == 10.0
    assert a.burn_long == pytest.approx(5.0)
    assert a.burn_short >= a.threshold
    assert t.gauges() == jt.gauges()


def test_slo_short_window_resets_alert():
    clk = FakeClock()
    t = SloTracker("x", objective=0.9, windows=((120.0, 2.0),),
                   min_events=4, clock=clk)
    for i in range(8):
        clk.t = float(i)
        t.record(good=False)
    assert t.evaluate()
    for i in range(20):
        clk.t = 8.0 + i
        t.record(good=True)
    assert t.burn_rate(120.0) > 2.0
    assert t.burn_rate(10.0) == 0.0
    assert t.evaluate() == []


def test_slo_min_events_significance_gate():
    clk = FakeClock()
    t = SloTracker("x", objective=0.99, windows=((60.0, 2.0),),
                   min_events=4, clock=clk)
    for i in range(3):
        clk.t = float(i)
        t.record(good=False)
    assert t.evaluate() == []
    clk.t = 3.0
    t.record(good=False)
    assert t.evaluate()


def test_slo_set_alerts_are_edge_triggered():
    clk = FakeClock()
    s = SloSet.serving(windows=((60.0, 2.0),), min_events=4, clock=clk)
    for i in range(6):
        clk.t = float(i)
        s.record("latency", good=False)
        s.record("staleness", good=True)
    assert len(s.evaluate()) == 1
    assert s.evaluate() == []
    g = s.gauges()
    assert g["slo_alerts_active"] == 1.0
    assert g["slo_latency_bad_total"] == 6.0
    assert g["slo_staleness_burn_60s"] == 0.0


def test_slo_percentile_matches_reference():
    from repro.obs.slo import percentile as jpct
    from repro_torch.obs.slo import percentile
    xs = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0]
    for q in (0, 10, 50, 90, 99, 100):
        assert percentile(xs, q) == jpct(xs, q)
    assert percentile([], 50) is None


# ---------------------------------------------------------------------------
# flight recorder: capture -> replay bit-for-bit
# ---------------------------------------------------------------------------

KERNEL = dict(engine="kernel", kernel_opts=dict(be=32, vb=64))


@pytest.mark.parametrize("engine_kw", [dict(), KERNEL],
                         ids=["xla", "kernel"])
def test_capture_then_replay_is_bitwise(engine_kw):
    mon = _monitor()
    ingest, store, engine, _ = _service(_graph(), monitor=mon, **engine_kw)
    engine.bootstrap()
    n = _feed(ingest, engine, num_batches=8)
    assert n == 8 and len(mon.recorder) == 8
    report = replay(mon.recorder, device=CPU)
    assert report.anchor_generation == 0
    assert len(report.steps) == 8
    assert report.ok and report.num_bitwise == 8
    assert "8/8 bit-for-bit" in report.describe()
    assert report.steps[-1].digest == rank_digest(store.snapshot().ranks)


@pytest.mark.parametrize("engine_kw", [dict(), KERNEL],
                         ids=["xla", "kernel"])
def test_replay_builds_its_own_caches(engine_kw, monkeypatch):
    """The replayed engine uploads the anchor into new tensors: every
    order (and the kernel engine's chunk plans) is built anew, none is
    taken from the live engine's cache."""
    from repro_torch.kernels.segment_ops import plan as plan_mod
    mon = _monitor()
    ingest, store, engine, _ = _service(_graph(), monitor=mon, **engine_kw)
    engine.bootstrap()
    _feed(ingest, engine, num_batches=3)
    live = {id(t) for t in (store.snapshot().graph.src,
                            store.snapshot().graph.dst,
                            store.snapshot().graph.valid)}
    seen = []
    real = plan_mod.cached

    def spy(tensors, key, build):
        ts = (tensors,) if isinstance(tensors, torch.Tensor) else tensors
        seen.append({id(t) for t in ts})
        return real(tensors, key, build)

    monkeypatch.setattr(plan_mod, "cached", spy)
    import repro_torch.graph.structure as structure
    monkeypatch.setattr(structure, "cached", spy)
    built = CACHE_BUILDS["pull_order"]
    assert replay(mon.recorder, device=CPU).ok
    # the anchor graph and each replayed batch's graph: an order each
    assert CACHE_BUILDS["pull_order"] >= built + 3
    assert seen and not any(ids & live for ids in seen)


def test_replay_window_end_gen_trims_tail():
    mon = _monitor()
    ingest, store, engine, _ = _service(_graph(), monitor=mon)
    engine.bootstrap()
    _feed(ingest, engine, num_batches=6)
    report = replay(mon.recorder, end_gen=3, device=CPU)
    assert [s.generation for s in report.steps] == [1, 2, 3]
    assert report.ok


def test_recorder_anchor_gc_keeps_replay_covered():
    mon = _monitor(recorder_capacity=6, anchor_every=2)
    ingest, store, engine, _ = _service(_graph(), monitor=mon)
    engine.bootstrap()
    _feed(ingest, engine, num_batches=12)
    rec = mon.recorder
    assert len(rec) == 6
    oldest = rec.records[0].generation
    assert min(rec.anchor_generations) <= oldest - 1
    assert len(rec.anchor_generations) <= 4
    assert replay(rec, device=CPU).ok


def test_incident_bundle_roundtrip_with_injected_fault(tmp_path):
    idir = str(tmp_path / "incidents")
    mon = _monitor(incident_dir=idir, shadow_every=4,
                   shadow_background=False)
    ingest, store, engine, metrics = _service(_graph(), monitor=mon)
    engine.bootstrap()
    engine.inject_fault(3, kind="rank", vertex=0, scale=4.0)
    _feed(ingest, engine, num_batches=8)
    errors = [i for i in mon.incidents if i.severity == "error"]
    assert errors and errors[0].generation == 3
    assert errors[0].kind == "rank_mass"
    assert engine.faults_injected == 1
    assert metrics.as_dict()["faults_injected"] == 1.0
    assert mon.last_bundle == os.path.join(idir, "incident_gen00000003")
    cfg, a, state, a_seq, records, incident = load_bundle(mon.last_bundle)
    assert incident["kind"] == "rank_mass"
    assert any(r.fault for r in records)
    report = replay(mon.last_bundle, device=CPU)
    assert report.ok and report.num_bitwise == len(report.steps)
    from repro_torch.launch.replay import main as replay_main
    out_json = str(tmp_path / "report.json")
    assert replay_main([mon.last_bundle, "--strict", "--device", "cpu",
                        "--json", out_json]) == 0
    with open(out_json) as f:
        assert json.load(f)["ok"] is True


def test_event_fault_is_recorded_and_replayed(tmp_path):
    mon = _monitor()
    ingest, store, engine, _ = _service(_graph(), monitor=mon)
    engine.bootstrap()
    engine.inject_fault(2, kind="event", vertex=5)
    _feed(ingest, engine, num_batches=4)
    rec = mon.recorder.records[1]
    assert rec.generation == 2 and rec.fault["kind"] == "event"
    ins = rec.update["ins_dst"][rec.update["ins_mask"]]
    assert ins.size and np.all(ins == 5)
    assert replay(mon.recorder, device=CPU).ok


def test_replay_refuses_unanchored_configs(tmp_path):
    mon = _monitor()
    ingest, store, engine, _ = _service(_graph(), monitor=mon)
    engine.bootstrap()
    _feed(ingest, engine, num_batches=2)
    bundle = mon.recorder.dump(str(tmp_path / "b"))
    man_path = os.path.join(bundle, "manifest.json")
    with open(man_path) as f:
        man = json.load(f)
    for key in ("mesh", "ppr"):
        man["config"][key] = True
        with open(man_path, "w") as f:
            json.dump(man, f)
        with pytest.raises(NotImplementedError):
            replay(bundle, device=CPU)
        man["config"][key] = False


def test_replay_with_ppr_index_is_bitwise(tmp_path):
    from repro_torch.ppr import IndexConfig
    mon = _monitor()
    ingest, store, engine, _ = _service(
        _graph(), monitor=mon,
        ppr_index=IndexConfig(num_walks=8, max_len=8, seed=3))
    engine.bootstrap()
    _feed(ingest, engine, num_batches=6)
    assert mon.recorder.config["ppr"]["key"] is not None
    assert engine.metrics.walks_resampled > 0
    report = replay(mon.recorder, device=CPU)
    assert report.ok and report.num_bitwise == 6
    bundle = mon.recorder.dump(str(tmp_path / "b"))
    assert replay(bundle, device=CPU).ok


# ---------------------------------------------------------------------------
# monitor wiring: gauges, summary and host syncs through the engine
# ---------------------------------------------------------------------------

def test_monitor_gauges_flow_into_serve_metrics():
    mon = _monitor(shadow_every=2, shadow_background=False)
    ingest, store, engine, metrics = _service(_graph(), monitor=mon)
    engine.bootstrap()
    _feed(ingest, engine, num_batches=5)
    engine.close()
    m = metrics.as_dict()
    for key in ("sentinel_rank_mass_err", "sentinel_trips",
                "shadow_samples", "shadow_l1", "slo_alerts_active",
                "slo_latency_bad_total", "incidents_total"):
        assert key in m, key
    assert m["shadow_samples"] == 3.0
    assert m["incidents_total"] == 0.0
    s = mon.summary()
    assert s["batches"] == 5 and s["incident_bundle"] is None
    text = MetricsExporter(metrics).scrape()
    assert "repro_shadow_l1" in text and "repro_sentinel_trips" in text


@pytest.mark.parametrize("engine_kw", [dict(), KERNEL],
                         ids=["xla", "kernel"])
def test_monitor_adds_one_host_sync_a_batch(engine_kw):
    """The sentinel's one read a batch; an anchor batch adds one read a
    state leaf (5 graph + ranks leaves, and 9 packed leaves on the kernel
    engine).  Snapshots are bitwise those of the unmonitored run."""
    runs = {}
    for mon in (None, _monitor(anchor_every=3)):
        ingest, store, engine, metrics = _service(_graph(), monitor=mon,
                                                  **engine_kw)
        engine.bootstrap()
        _feed(ingest, engine, num_batches=7)
        runs[mon is not None] = (metrics, store.snapshot().ranks)
    off, on = runs[False][0], runs[True][0]
    leaves = 5 + (len(_PACKED_LEAVES) if engine_kw else 0)
    want = [s + 1 + (leaves if (b + 1) % 3 == 0 else 0)
            for b, s in enumerate(off.batch_host_syncs)]
    assert on.batch_host_syncs == want
    assert on.batch_iterations == off.batch_iterations
    assert torch.equal(runs[True][1], runs[False][1])


@pytest.mark.parametrize("engine_kw", [dict(), KERNEL],
                         ids=["xla", "kernel"])
def test_default_monitor_with_telemetry_serves(engine_kw):
    """``ServeEngine(telemetry=True, monitor=CorrectnessMonitor())``: the
    reference's defaults (shadow every 64 batches in the background)."""
    mon = CorrectnessMonitor()
    assert mon.config == MonitorConfig()
    import dataclasses
    assert dataclasses.asdict(mon.config) == \
        dataclasses.asdict(jobs.MonitorConfig())
    ingest, store, engine, metrics = _service(_graph(), monitor=mon,
                                              telemetry=True, **engine_kw)
    engine.bootstrap()
    assert _feed(ingest, engine, num_batches=3) == 3
    engine.close()
    assert mon.sentinel.batches == 3 and mon.incidents == []
    assert mon.shadow.samples == 1                 # batch 0 only
    assert len(metrics.frontier_summaries) == 3
    assert engine.last_telemetry.iterations == metrics.batch_iterations[-1]


def test_monitor_close_drains_background_shadow():
    mon = _monitor(shadow_every=1, shadow_background=True)
    ingest, store, engine, metrics = _service(_graph(), monitor=mon)
    engine.bootstrap()
    _feed(ingest, engine, num_batches=3)
    engine.close()
    engine.close()                                # idempotent
    sv = mon.shadow
    assert sv.samples + sv.skipped == 3
    assert all(r.l1 <= 1e-4 and r.linf <= 1e-5 for r in sv.reports)


# ---------------------------------------------------------------------------
# bundles across the two packages
# ---------------------------------------------------------------------------

def _both_bundles(tmp_path, num_batches=6):
    """The same graph and feed served by each package's xla engine, each
    monitored; returns (port bundle, reference bundle)."""
    jg = _jgraph()
    events = _events(num_batches)
    jmon = jobs.CorrectnessMonitor(jobs.MonitorConfig(
        shadow_every=0, anchor_every=4, recorder_capacity=64))
    jing = JIngest(flush_size=4, flush_interval=0.0)
    jeng = JEngine(jg, jing, JStore(), method="frontier_prune",
                   monitor=jmon)
    jeng.bootstrap()
    mon = _monitor()
    ing, _, eng, _ = _service(port_graph(jg), monitor=mon)
    eng.bootstrap()
    for u, v in events:
        jing.submit_insert(u, v)
        ing.submit_insert(u, v)
    assert jeng.drain() == eng.drain() == num_batches
    return (mon.recorder.dump(str(tmp_path / "port")),
            jmon.recorder.dump(str(tmp_path / "ref")))


def _assert_same_bundle(a, b, digests=True):
    cfg_a, ga, sa, qa, ra, _ = a
    cfg_b, gb, sb, qb, rb, _ = b
    assert (ga, qa) == (gb, qb)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype, k
        if k == "ranks" and not digests:     # two f64 engines: ~1e-12
            np.testing.assert_allclose(sa[k], sb[k], rtol=0, atol=1e-12)
        else:
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    assert len(ra) == len(rb)
    for x, y in zip(ra, rb):
        mx, my = x.meta(), y.meta()
        if not digests:
            for d in (mx, my):
                d.pop("digest")
                d.pop("oldest_t")
        assert mx == my
        for f in x.update:
            np.testing.assert_array_equal(x.update[f], y.update[f])
    return cfg_a, cfg_b


def test_bundles_load_in_both_packages(tmp_path):
    port_b, ref_b = _both_bundles(tmp_path)
    # each package reads the other's bundle to identical arrays
    _assert_same_bundle(load_bundle(ref_b), jobs.load_bundle(ref_b))
    _assert_same_bundle(jobs.load_bundle(port_b), load_bundle(port_b))
    # and the two recordings of one feed agree in everything but the
    # digests (and arrival clocks): same anchor, updates, decisions
    cfg_p, cfg_r = _assert_same_bundle(load_bundle(port_b),
                                       load_bundle(ref_b), digests=False)
    for key in ("method", "engine", "num_vertices", "edge_capacity",
                "ingest_capacity", "mesh", "ppr", "static_fallback_frac"):
        assert cfg_p[key] == cfg_r[key], key


def test_replay_other_packages_bundle(tmp_path):
    port_b, ref_b = _both_bundles(tmp_path)
    for rep, bundle in ((replay(ref_b, device=CPU), ref_b),
                        (jobs.replay(port_b), port_b)):
        recs = load_bundle(bundle)[4]
        assert [s.generation for s in rep.steps] == \
            [r.generation for r in recs]
        assert all(s.decisions_match for s in rep.steps)
    # within one package the replay is bitwise
    assert replay(port_b, device=CPU).ok and jobs.replay(ref_b).ok


# ---------------------------------------------------------------------------
# export hardening: JSONL rotation, exporter lifecycle
# ---------------------------------------------------------------------------

def test_jsonl_sink_rotates_at_size_cap(tmp_path):
    path = str(tmp_path / "telemetry.jsonl")
    sink = JsonlSink(path, max_bytes=400, backups=2, clock=lambda: 1.0)
    for i in range(40):
        sink.write({"i": i, "pad": "x" * 32})
    sink.close()
    assert sink.rotations >= 2
    assert os.path.exists(path + ".1") and os.path.exists(path + ".2")
    assert not os.path.exists(path + ".3")
    for p in (path, path + ".1", path + ".2"):
        assert os.path.getsize(p) <= 400
        with open(p) as f:
            rows = [json.loads(line) for line in f]
        assert all("i" in r for r in rows)


def test_jsonl_sink_truncates_with_zero_backups(tmp_path):
    path = str(tmp_path / "t.jsonl")
    sink = JsonlSink(path, max_bytes=200, backups=0)
    for i in range(20):
        sink.write({"i": i})
    sink.close()
    assert sink.rotations >= 1
    assert not os.path.exists(path + ".1")
    sink.write({"late": True})
    sink.close()


def test_metrics_exporter_lifecycle():
    exp = MetricsExporter(ServeMetrics())
    port = exp.serve(port=0)
    assert port > 0 and exp.port == port
    with pytest.raises(RuntimeError):
        exp.serve(port=0)
    exp.close()
    assert exp.port is None
    exp.close()
    with exp:
        assert exp.serve(port=0) > 0
    assert exp.port is None


# ---------------------------------------------------------------------------
# the serve driver and the replay driver
# ---------------------------------------------------------------------------

def test_serve_driver_fault_dump_then_replay_cli(tmp_path, capsys):
    from repro_torch.launch.replay import main as replay_main
    from repro_torch.launch.serve import main as serve_main
    idir = str(tmp_path / "incidents")
    trace = str(tmp_path / "trace.json")
    prom = str(tmp_path / "metrics.prom")
    rc = serve_main(["--device", "cpu", "--engine", "kernel",
                     "--events", "120", "--flush-size", "16",
                     "--query-every", "40", "--monitor",
                     "--shadow-every", "2", "--incident-dir", idir,
                     "--inject-fault", "3:rank:0:4.0", "--trace", trace,
                     "--metrics-path", prom])
    out = capsys.readouterr().out
    assert rc == 0 and "serve complete" in out and "fault armed" in out
    summary = json.loads(next(ln for ln in out.splitlines()
                              if ln.startswith("monitor "))[8:])
    # vertex 0's rank is too small here for the mass sentinel: the shadow
    # catches the fault (its thread may report it a batch or two later,
    # and the bundle is named for the batch that drained the incident)
    assert summary["incidents_by_kind"].get("shadow_linf", 0) >= 1
    bundle = summary["incident_bundle"]
    assert os.path.dirname(bundle) == idir
    assert any(r.fault for r in load_bundle(bundle)[4])
    assert json.load(open(trace))["traceEvents"]
    assert os.path.getsize(trace + ".frontier.jsonl") > 0
    assert "repro_sentinel_trips" in open(prom).read()
    assert replay_main([bundle, "--strict", "--device", "cpu"]) == 0
    assert "bit-for-bit" in capsys.readouterr().out


def test_serve_driver_refuses_mesh(tmp_path, monkeypatch, capsys):
    """``--mesh test`` is ported: the kernel engine serves sharded over
    the 2 x 2 test mesh's model axis; ``--mesh production`` needs 256
    cards and is refused here."""
    from repro_torch.launch.serve import main as serve_main
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "t.json"))
    rc = serve_main(["--device", "cpu", "--mesh", "test", "--engine",
                     "kernel", "--events", "150", "--min-queries", "1"])
    out = capsys.readouterr().out
    assert rc == 0 and "shards=2" in out and "kernel geometry:" in out
    assert "serve complete" in out
    with pytest.raises(RuntimeError, match="production mesh"):
        serve_main(["--device", "cpu", "--mesh", "production"])
