"""repro_torch.obs against repro.obs: span tracer, frontier telemetry,
exporters, and the free-when-off contract of the traced serving stack.

The loops' telemetry rows are held against ``repro``'s on the same
seeded inputs: the f64 loop's ``affected``, ``grew``, ``pruned`` and
``active`` exactly and its ``residual`` within rtol 1e-6 / atol 1e-12
(the f64 sums are taken in another order); the kernel loop's to the
reference's own kernel-vs-xla contract (``affected`` exact, ``residual``
rtol 1e-3 over the first ≤ 10 iterations).  Telemetry changes no rank,
no iteration and no host sync.
"""
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables x64 for the reference)
from repro import obs as jobs
from repro.core import kernel_engine as jke
from repro.core import pagerank as jpr
from repro.graph import generators as jgen
from repro.graph import structure as jstr
from repro.kernels.pagerank_spmv import update as jupd

from repro_torch import obs
from repro_torch import device as tdevice
from repro_torch.core import api as tapi
from repro_torch.core import kernel_engine as tke
from repro_torch.core import pagerank as tpr
from repro_torch.graph.generators import erdos_renyi_edges, rmat_edges
from repro_torch.graph.structure import from_coo
from repro_torch.obs.frontier import FIELDS, NUM_FIELDS, FrontierTelemetry
from repro_torch.obs.trace import Tracer, _NOP
from repro_torch.serve import IngestQueue, RankStore, ServeEngine, \
    ServeMetrics
from test_torch_common import CPU, assert_bitwise, port_graph, port_packed

KERNEL_OPTS = dict(be=256, vb=256)


def _jgraph(seed=0, n_exp=9, ef=8, cap_extra=512):
    edges, n = jgen.rmat_edges(n_exp, ef, seed=seed)
    return jstr.from_coo(edges[:, 0], edges[:, 1], n,
                         edge_capacity=len(edges) + cap_extra)


def _graph(seed=0, n_exp=9, ef=8, cap_extra=512):
    edges, n = rmat_edges(n_exp, ef, seed=seed)
    return from_coo(edges[:, 0], edges[:, 1], n,
                    edge_capacity=len(edges) + cap_extra, device=CPU)


def _service(graph, flush_size=8, **engine_kw):
    metrics = ServeMetrics()
    ingest = IngestQueue(flush_size=flush_size, flush_interval=0.0,
                         max_pending=4096, device=CPU)
    store = RankStore()
    engine = ServeEngine(graph, ingest, store, metrics=metrics,
                         method="frontier_prune", **engine_kw)
    return ingest, store, engine, metrics


def _feed(ingest, engine, n, events, rng):
    for _ in range(events):
        u, v = rng.integers(0, n, size=2)
        if u != v:
            ingest.submit_insert(int(u), int(v))
    engine.drain()


def _touched_case(seed, k):
    """(jax graph, port graph, uniform ranks, initial affected of k
    touched vertices) on one seeded R-MAT graph."""
    jg = _jgraph(seed=seed)
    tg = port_graph(jg)
    V = jg.num_vertices
    touched = np.zeros(V, bool)
    touched[:k] = True
    aff = np.array(jpr.initial_affected(jg, jg, touched))
    r0 = np.full(V, 1.0 / V)
    return jg, tg, r0, aff


# ---------------------------------------------------------------------------
# timeit + tracer core
# ---------------------------------------------------------------------------

def test_timeit_measures_elapsed():
    fake = iter([10.0, 10.25])
    with obs.timeit(clock=lambda: next(fake)) as t:
        pass
    assert t.seconds == pytest.approx(0.25)


def test_tracer_records_spans_with_args():
    tr = Tracer()
    with tr.span("outer", k=1):
        with tr.span("inner"):
            pass
    spans = tr.spans()
    assert [s.name for s in spans] == ["inner", "outer"]
    outer = tr.spans("outer")[0]
    inner = tr.spans("inner")[0]
    assert outer.args == {"k": 1}
    assert outer.tid == inner.tid
    assert outer.t0 <= inner.t0
    assert inner.t0 + inner.dur <= outer.t0 + outer.dur + 1e-9


def test_tracer_spans_nest_per_thread():
    tr = Tracer()
    barrier = threading.Barrier(2)

    def work(name):
        barrier.wait()
        with tr.span(name):
            pass

    threads = [threading.Thread(target=work, args=(f"t{i}",))
               for i in range(2)]
    with tr.span("main"):
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    spans = {s.name: s for s in tr.spans()}
    assert set(spans) == {"main", "t0", "t1"}
    assert spans["t0"].tid != spans["t1"].tid
    assert spans["t0"].tid != spans["main"].tid


def test_disabled_tracer_is_free_and_shared():
    tr = Tracer(enabled=False)
    assert tr.span("x") is _NOP
    with tr.span("x"):
        pass
    tr.record("y", 0.0, 1.0)
    tr.instant("z")
    assert len(tr) == 0
    before = tdevice.host_sync_count()
    tr.sync(torch.zeros(3))              # disabled: no wait, no sync
    tr.sync(object())
    assert tdevice.host_sync_count() == before


def test_tracer_sync_records_one_host_sync():
    tr = Tracer()
    before = tdevice.host_sync_count()
    tr.sync((torch.zeros(3), torch.ones(2)))
    assert tdevice.host_sync_count() == before + 1
    tr.sync(None)
    tr.sync("not a tensor")
    assert tdevice.host_sync_count() == before + 1


def test_tracer_ring_buffer_drops_oldest():
    tr = Tracer(capacity=4)
    for i in range(10):
        tr.record(f"s{i}", float(i), 0.5)
    assert len(tr) == 4
    assert [s.name for s in tr.spans()] == ["s6", "s7", "s8", "s9"]
    assert tr.to_chrome()["otherData"]["dropped_events"] == 6


def test_chrome_trace_round_trips_through_json(tmp_path):
    tr = Tracer()
    with tr.span("phase", detail="abc"):
        pass
    tr.instant("marker", n=np.int64(3), t=torch.tensor(4))
    tr.counter("frontier", affected=7)
    path = tr.write(str(tmp_path / "trace.json"))
    doc = json.loads(open(path).read())
    complete = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(complete) == 1
    ev = complete[0]
    assert ev["name"] == "phase"
    assert isinstance(ev["ts"], float) and isinstance(ev["dur"], float)
    assert ev["args"] == {"detail": "abc"}
    assert {"X", "i", "C", "M"} <= {e["ph"] for e in doc["traceEvents"]}
    inst = [e for e in doc["traceEvents"] if e["ph"] == "i"][0]
    assert inst["args"] == {"n": 3, "t": 4}


def test_global_tracer_disabled_by_default_and_scoped():
    assert not obs.get_tracer().enabled
    assert obs.span("x") is _NOP
    with obs.tracing() as tr:
        assert obs.get_tracer() is tr and tr.enabled
        with obs.span("inside"):
            pass
        assert len(tr.spans("inside")) == 1
    assert not obs.get_tracer().enabled


def test_traced_decorator():
    calls = []

    @obs.traced("decorated")
    def fn(x):
        calls.append(x)
        return x + 1

    assert fn(1) == 2
    with obs.tracing() as tr:
        assert fn(2) == 3
        assert len(tr.spans("decorated")) == 1
    assert calls == [1, 2]


def test_public_names_match_reference():
    assert obs.__all__ == jobs.__all__
    assert obs.TELEMETRY_FIELDS == jobs.TELEMETRY_FIELDS
    assert obs.TELEMETRY_NUM_FIELDS == jobs.TELEMETRY_NUM_FIELDS


# ---------------------------------------------------------------------------
# frontier telemetry: schema, loops, engine parity
# ---------------------------------------------------------------------------

def test_frontier_schema_helpers():
    rows = np.arange(2 * NUM_FIELDS, dtype=np.float64).reshape(2, NUM_FIELDS)
    ft = FrontierTelemetry(rows)
    ref = jobs.FrontierTelemetry(rows)
    assert ft.iterations == 2
    for i, name in enumerate(FIELDS):
        assert ft.column(name).tolist() == [float(i), float(i + NUM_FIELDS)]
    assert ft.summary() == ref.summary()
    assert ft.rows() == ref.rows()
    cat = FrontierTelemetry.concat(ft, FrontierTelemetry(rows[:1]))
    assert cat.iterations == 3
    assert FrontierTelemetry.concat().iterations == 0
    assert FrontierTelemetry.from_padded(rows, 1).iterations == 1


_LOOP_CASES = {
    "static": dict(),
    "traversal": dict(),
    "frontier": dict(expand=True),
    "frontier_prune": dict(expand=True, prune=True, closed_form=True),
}


@pytest.mark.parametrize("method", list(_LOOP_CASES))
def test_f64_loop_telemetry_matches_reference(method):
    jg, tg, r0, aff = _touched_case(seed=1, k=4)
    if method == "static":
        aff = np.ones_like(aff)
    kw = dict(tol=1e-10, frontier_tol=1e-6, prune_tol=1e-6, max_iter=200,
              **_LOOP_CASES[method])
    ref = jpr._pagerank_loop(jg, r0, aff, telemetry=True, **kw)
    out = tpr._pagerank_loop(tg, torch.from_numpy(r0), torch.from_numpy(aff),
                             telemetry=True, **kw)
    want = jobs.FrontierTelemetry.from_padded(ref.telemetry,
                                              ref.iterations).data
    got = out.telemetry
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert got.shape == want.shape == (out.iterations, NUM_FIELDS)
    for name in ("affected", "grew", "pruned", "active"):
        i = FIELDS.index(name)
        np.testing.assert_array_equal(got[:, i], want[:, i], err_msg=name)
    i = FIELDS.index("residual")
    np.testing.assert_allclose(got[:, i], want[:, i], rtol=1e-6, atol=1e-12)
    # the first row's affected is the initial set, the last residual the
    # loop's final delta
    assert got[0, 0] == float(aff.sum())
    assert got[-1, 1] == float(out.delta)


@pytest.mark.parametrize("prune", [False, True], ids=["df", "dfp"])
def test_kernel_loop_telemetry_matches_reference(prune):
    jg, tg, r0, aff = _touched_case(seed=5, k=8)
    jpacked = jupd.pack_graph(jg, be=256, vb=256)
    kw = dict(tol=1e-7, frontier_tol=1e-5, prune_tol=1e-5, max_iter=100,
              expand=True, prune=prune, closed_form=prune)
    ref = jke.kernel_pagerank_loop(jg, jpacked, r0, aff, use_kernel=False,
                                   telemetry=True, **kw)
    out = tke.kernel_pagerank_loop(tg, port_packed(jpacked),
                                   torch.from_numpy(r0),
                                   torch.from_numpy(aff), telemetry=True,
                                   **kw)
    want = jobs.FrontierTelemetry.from_padded(ref.telemetry,
                                              ref.iterations).data
    got = out.telemetry
    assert got.shape == (out.iterations, NUM_FIELDS)
    m = min(10, len(got), len(want))
    assert m >= 3
    np.testing.assert_array_equal(got[:m, 0], want[:m, 0])
    np.testing.assert_allclose(got[:m, 1], want[:m, 1], rtol=1e-3)
    # active = active windows of the 256-vertex packing
    assert np.all(got[:, 4] <= -(-tg.num_vertices // 256))


@pytest.mark.parametrize("engine", ["xla", "kernel"])
def test_telemetry_leaves_ranks_and_iterations_unchanged(engine):
    jg, tg, r0, aff = _touched_case(seed=7, k=8)
    kw = dict(prune=True, closed_form=True, expand=True)
    if engine == "kernel":
        packed = port_packed(jupd.pack_graph(jg, be=256, vb=256))
        run = lambda tel: tke.hybrid_pagerank(  # noqa: E731
            tg, packed, torch.from_numpy(r0), torch.from_numpy(aff),
            telemetry=tel, **kw)
    else:
        run = lambda tel: tpr._pagerank_loop(  # noqa: E731
            tg, torch.from_numpy(r0), torch.from_numpy(aff), telemetry=tel,
            **kw)
    base, tel = run(False), run(True)
    assert base.telemetry is None
    assert_bitwise(base.ranks, tel.ranks)
    assert base.iterations == tel.iterations
    assert base.host_syncs == tel.host_syncs
    assert tel.telemetry.shape == (tel.iterations, NUM_FIELDS)


def test_hybrid_telemetry_concatenates_phases():
    jg, tg, r0, aff = _touched_case(seed=7, k=8)
    packed = port_packed(jupd.pack_graph(jg, be=256, vb=256))
    kw = dict(prune=True, closed_form=True, telemetry=True)
    k = tke.kernel_pagerank_loop(tg, packed, torch.from_numpy(r0),
                                 torch.from_numpy(aff), **kw)
    res = tke.hybrid_pagerank(tg, packed, torch.from_numpy(r0),
                              torch.from_numpy(aff), **kw)
    assert res.telemetry.shape == (res.iterations, NUM_FIELDS)
    # kernel rows first (f32 values), then the polish's
    np.testing.assert_array_equal(res.telemetry[:k.iterations], k.telemetry)
    nopolish = tke.hybrid_pagerank(tg, packed, torch.from_numpy(r0),
                                   torch.from_numpy(aff), polish=False,
                                   **kw)
    np.testing.assert_array_equal(nopolish.telemetry, k.telemetry)


def test_kernel_loop_at_max_iter_reads_its_last_row():
    jg, tg, r0, aff = _touched_case(seed=7, k=8)
    packed = port_packed(jupd.pack_graph(jg, be=256, vb=256))
    args = (tg, packed, torch.from_numpy(r0), torch.from_numpy(aff))
    base = tke.kernel_pagerank_loop(*args, max_iter=3)
    tel = tke.kernel_pagerank_loop(*args, max_iter=3, telemetry=True)
    assert base.iterations == tel.iterations == 3
    assert tel.telemetry.shape == (3, NUM_FIELDS)
    # the one case with a read of its own: the sweep at the cap
    assert tel.host_syncs == base.host_syncs + 1


@pytest.mark.parametrize("engine", ["xla", "kernel"])
def test_update_pagerank_threads_telemetry(engine):
    jg, tg, r0, aff = _touched_case(seed=3, k=4)
    from repro_torch.graph.dynamic import make_batch_update
    upd = make_batch_update(np.zeros((0, 2)), np.array([[0, 5], [7, 1]]),
                            8, 8, device=CPU)
    from repro_torch.graph.dynamic import apply_batch
    g2 = apply_batch(tg, upd)
    res = tapi.update_pagerank(tg, g2, upd, torch.from_numpy(r0),
                               "frontier_prune", engine=engine,
                               telemetry=True)
    assert res.telemetry.shape == (res.iterations, NUM_FIELDS)


# ---------------------------------------------------------------------------
# free when off: host syncs unchanged by telemetry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["xla", "kernel"])
def test_telemetry_adds_no_host_sync_to_a_batch(engine):
    kw = dict(kernel_opts=KERNEL_OPTS) if engine == "kernel" else {}
    runs = {}
    for tel in (False, True):
        g = _graph(seed=2, cap_extra=2048)
        ingest, store, eng, metrics = _service(g, engine=engine,
                                               telemetry=tel, **kw)
        eng.bootstrap()
        _feed(ingest, eng, g.num_vertices, 48, np.random.default_rng(0))
        runs[tel] = (metrics, store.snapshot().ranks)
    off, on = runs[False][0], runs[True][0]
    assert len(off.batch_host_syncs) >= 4
    assert on.batch_host_syncs == off.batch_host_syncs
    assert on.batch_iterations == off.batch_iterations
    assert_bitwise(runs[True][1], runs[False][1])
    assert len(on.frontier_summaries) == len(on.batch_host_syncs)
    assert not off.frontier_summaries


def test_tracing_adds_one_sync_a_closed_device_span():
    g = _graph(seed=3, cap_extra=2048)
    ingest, _, eng, metrics = _service(g, engine="kernel", telemetry=False,
                                       kernel_opts=KERNEL_OPTS)
    eng.bootstrap()
    rng = np.random.default_rng(1)
    _feed(ingest, eng, g.num_vertices, 16, rng)
    untraced = list(metrics.batch_host_syncs)
    with obs.tracing() as tr:
        _feed(ingest, eng, g.num_vertices, 16, rng)
        fused = tr.spans("fused_update_loop")
        polish = tr.spans("polish.f64")
    traced = metrics.batch_host_syncs[len(untraced):]
    assert len(traced) == len(fused) == len(polish) > 0
    # every rank batch: the same reads, plus the two span closes; the
    # batches' own reads vary with their iterations
    it = metrics.batch_iterations[len(untraced):]
    it0 = metrics.batch_iterations[:len(untraced)]
    base = untraced[0] - it0[0]
    assert all(s - i == base + 2 for s, i in zip(traced, it))


# ---------------------------------------------------------------------------
# serve engine: span tree + telemetry capture + gauges
# ---------------------------------------------------------------------------

def test_serve_step_span_tree_and_telemetry(tmp_path):
    g = _graph(seed=4, n_exp=11, cap_extra=2048)
    n = g.num_vertices
    ingest, _, engine, metrics = _service(g, engine="kernel",
                                          kernel_opts=KERNEL_OPTS)
    engine.bootstrap()
    sink_path = str(tmp_path / "frontier.jsonl")
    engine.telemetry_sink = obs.JsonlSink(sink_path)
    rng = np.random.default_rng(2)
    trace_path = str(tmp_path / "trace.json")
    with obs.tracing(trace_path) as tr:
        _feed(ingest, engine, n, 40, rng)
        names = {s.name for s in tr.spans()}
        instants = tr.to_chrome()["traceEvents"]
    engine.telemetry_sink.close()
    assert {"serve.step", "ingest.coalesce", "route_update",
            "fused_update_loop", "polish.f64",
            "snapshot.publish"} <= names
    assert any(e["name"] == "frontier.telemetry" and e["ph"] == "i"
               for e in instants)
    steps = tr.spans("serve.step")
    inner = tr.spans("fused_update_loop")
    for s0 in steps:
        assert any(s0.t0 <= sp.t0 and sp.t0 + sp.dur <= s0.t0 + s0.dur + 1e-9
                   for sp in inner)
    assert engine.last_telemetry is not None
    assert engine.last_telemetry.data.shape[1] == NUM_FIELDS
    d = metrics.as_dict()
    assert d["frontier_batches"] == len(steps) >= 1
    assert d["frontier_iterations_mean"] > 0
    # a batch's rows equal its iterations, the first row's affected its
    # initial set (a subset of its affected_ever)
    assert engine.last_telemetry.iterations == metrics.batch_iterations[-1]
    lines = [json.loads(ln) for ln in open(sink_path)]
    assert len(lines) == d["frontier_batches"]
    assert lines[0]["kind"] == "frontier"
    assert set(lines[0]["rows"][0]) == set(FIELDS)
    doc = json.loads(open(trace_path).read())
    evs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert {e["name"] for e in evs} >= {"serve.step", "fused_update_loop"}


def test_xla_engine_solve_span():
    g = _graph(seed=4, cap_extra=2048)
    ingest, _, engine, _ = _service(g)
    engine.bootstrap()
    with obs.tracing() as tr:
        _feed(ingest, engine, g.num_vertices, 16, np.random.default_rng(5))
        assert tr.spans("solve") and tr.spans("serve.step")
        assert not tr.spans("fused_update_loop")


def test_ppr_repair_span_recorded():
    from repro_torch.ppr import IndexConfig
    edges, n = erdos_renyi_edges(64, 400, seed=0)
    g = from_coo(edges[:, 0], edges[:, 1], n,
                 edge_capacity=len(edges) + 512, device=CPU)
    ingest, _, engine, _ = _service(
        g, ppr_index=IndexConfig(num_walks=4, max_len=8, seed=0))
    engine.bootstrap()
    with obs.tracing() as tr:
        _feed(ingest, engine, n, 20, np.random.default_rng(3))
        spans = tr.spans("ppr.repair")
    assert spans
    assert all("stale" in (s.args or {}) for s in spans)


def test_engine_gauges_in_as_dict():
    g = _graph(seed=6, cap_extra=2048)
    ingest, _, engine, metrics = _service(g, engine="kernel",
                                          telemetry=False,
                                          kernel_opts=KERNEL_OPTS)
    engine.bootstrap()
    _feed(ingest, engine, g.num_vertices, 16, np.random.default_rng(4))
    d = metrics.as_dict()
    assert "staleness_in_events" in d
    for key in ("comm_bytes", "host_syncs_per_batch", "packed_rebuilds",
                "packed_rebuilds_by_shard", "events_per_s",
                "walks_resampled"):
        assert key in d
    metrics.set_gauge("events_per_s", -1.0)
    assert metrics.as_dict()["events_per_s"] != -1.0


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

_METRICS = dict(events_per_s=12.5, batches=3, skip_me="a string",
                flag=True, big=1.5e12, tiny=3.25e-9, neg=-2,
                npint=np.int64(7), npflt=np.float32(0.5),
                packed_rebuilds_by_shard={"0": 2, "3": 1, "x": "no"},
                empty={})


def test_prometheus_text_format():
    text = obs.prometheus_text(_METRICS)
    lines = text.strip().splitlines()
    assert "repro_events_per_s 12.5" in lines
    assert "repro_batches 3" in lines
    assert '# TYPE repro_packed_rebuilds_by_shard gauge' in lines
    assert 'repro_packed_rebuilds_by_shard{key="0"} 2' in lines
    assert not any("skip_me" in ln for ln in lines)


def test_prometheus_text_equals_reference_byte_for_byte():
    help_text = dict(batches="micro-batches served")
    for prefix in ("repro_", "x_"):
        assert obs.prometheus_text(_METRICS, prefix, help_text) == \
            jobs.prometheus_text(_METRICS, prefix, help_text)


def test_jsonl_sink_appends_records(tmp_path):
    path = str(tmp_path / "records.jsonl")
    sink = obs.JsonlSink(path, clock=lambda: 42.0)
    sink.write(dict(a=1, arr=np.arange(3)), kind="test")
    sink.write(dict(b=np.float32(2.5)))
    sink.close()
    rows = [json.loads(ln) for ln in open(path)]
    assert rows[0] == {"a": 1, "arr": [0, 1, 2], "kind": "test", "t": 42.0}
    assert rows[1]["b"] == 2.5


def test_metrics_exporter_scrape_server():
    m = ServeMetrics()
    m.record_batch(0.01, 8, 2, affected=5, iterations=3, fallback=False)
    m.set_gauge("halo_occupancy", 0.5)
    exporter = obs.MetricsExporter(m, extra=lambda: dict(extra_gauge=7))
    try:
        port = exporter.serve(port=0)
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics").read().decode()
        assert "repro_events_applied 8" in text
        assert "repro_halo_occupancy 0.5" in text
        assert "repro_extra_gauge 7" in text
        blob = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics.json").read()
        d = json.loads(blob)
        assert d["events_applied"] == 8 and d["extra_gauge"] == 7
        with pytest.raises(Exception):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope")
    finally:
        exporter.close()


def test_metrics_exporter_write(tmp_path):
    m = ServeMetrics()
    m.record_batch(0.02, 4, 0, affected=2, iterations=1, fallback=True)
    path = str(tmp_path / "metrics.prom")
    obs.MetricsExporter(m).write(path)
    text = open(path).read()
    assert "repro_static_fallbacks 1" in text
    assert text.endswith("\n")
