"""The serve engine's host-sync count (``ServeMetrics.batch_host_syncs``)
on the CPU.

Every call of a step that synchronizes the host with the card records
itself (``device.note_host_syncs``), whatever the device, so the count
here is the one the card sees; ``tests/test_torch_cuda.py`` holds it
equal to ``torch.cuda.set_sync_debug_mode``'s count there.  These tests
pin what a rank-path batch is made of: six uploads of the polled batch,
five boolean-mask selections in ``apply_batch`` and eight in the packed
update, the fallback check, the overflow check, one read per solver
iteration and the read of the batch's counters.
"""
import threading

import numpy as np
import pytest

from repro_torch import device as tdevice
from repro_torch.graph.generators import random_batch_update, rmat_edges
from repro_torch.graph.structure import from_coo
from repro_torch.serve import IngestQueue, RankStore, ServeEngine, \
    ServeMetrics
from repro_torch.serve import engine as serve_engine
from test_torch_common import CPU

UPLOADS, APPLY_BATCH, PACKED = 6, 5, 8
# every rank batch: the uploads, the graph update and the fallback check
BATCH = UPLOADS + APPLY_BATCH + 1


def _engine(engine, static_fallback_frac=1.0, **kw):
    edges, n = rmat_edges(10, 8, seed=4)
    graph = from_coo(edges[:, 0], edges[:, 1], n, device=CPU)
    ingest = IngestQueue(flush_size=64, flush_interval=1e9, device=CPU)
    eng = ServeEngine(graph, ingest, RankStore(), metrics=ServeMetrics(),
                      engine=engine,
                      static_fallback_frac=static_fallback_frac, **kw)
    eng.bootstrap()
    return eng, ingest, edges, n


def _submit(ingest, edges, n, b):
    dele, ins = random_batch_update(edges, n, 64, seed=20 + b)
    for u, v in dele:
        ingest.submit_delete(int(u), int(v))
    for u, v in ins:
        ingest.submit_insert(int(u), int(v))


def _solver_syncs(monkeypatch, name):
    """Wrap the engine's ``name`` solver and keep each result's own
    ``host_syncs`` (its reads)."""
    seen = []
    real = getattr(serve_engine, name)

    def wrapped(*a, **kw):
        out = real(*a, **kw)
        res = out[1] if isinstance(out, tuple) else out
        seen.append(res.host_syncs)
        return out

    monkeypatch.setattr(serve_engine, name, wrapped)
    return seen


def test_kernel_rank_batch_counts_graph_update_syncs(monkeypatch):
    eng, ingest, edges, n = _engine("kernel")
    seen = _solver_syncs(monkeypatch, "fused_hybrid_pagerank")
    for b in range(3):
        _submit(ingest, edges, n, b)
        assert eng.step(force=True)
    m = eng.metrics
    assert m.static_fallbacks == 0 and m.packed_rebuilds == 0
    assert len(seen) == 3
    # fused result: the overflow check, f32 reads and polish reads
    assert all(s > 2 for s in seen)
    assert m.batch_host_syncs == [BATCH + PACKED + s + 1 for s in seen]


def test_xla_rank_batch_counts_graph_update_syncs(monkeypatch):
    eng, ingest, edges, n = _engine("xla")
    seen = []
    real = eng._solve

    def solve(*a, **kw):
        res = real(*a, **kw)
        seen.append(res.host_syncs)
        return res

    monkeypatch.setattr(eng, "_solve", solve)
    for b in range(2):
        _submit(ingest, edges, n, b)
        assert eng.step(force=True)
    assert seen and all(s == it for s, it in
                        zip(seen, eng.metrics.batch_iterations))
    assert eng.metrics.batch_host_syncs == [BATCH + s + 1 for s in seen]


def test_static_fallback_batch_counts_packed_check(monkeypatch):
    eng, ingest, edges, n = _engine("kernel", static_fallback_frac=0.0)
    seen = _solver_syncs(monkeypatch, "fused_hybrid_pagerank")
    _submit(ingest, edges, n, 0)
    assert eng.step(force=True)
    m = eng.metrics
    assert m.static_fallbacks == 1 and not seen
    # the packed update with its overflow check, then the static f64 loop
    assert m.batch_host_syncs == [BATCH + PACKED + 1
                                  + m.batch_iterations[0] + 1]


def test_host_sync_count_is_per_thread():
    before = tdevice.host_sync_count()
    got = []

    def other():
        tdevice.note_host_syncs(5)
        got.append(tdevice.host_sync_count())

    th = threading.Thread(target=other)
    th.start()
    th.join()
    assert got == [5]
    assert tdevice.host_sync_count() == before
    tdevice.note_host_syncs(2)
    assert tdevice.host_sync_count() == before + 2


@pytest.mark.parametrize("walks", [0, 4])
def test_walk_index_adds_its_stale_count_read(monkeypatch, walks):
    from repro_torch.ppr import IndexConfig
    kw = dict(ppr_index=IndexConfig(num_walks=walks, max_len=6, seed=1)) \
        if walks else {}
    eng, ingest, edges, n = _engine("kernel", **kw)
    seen = _solver_syncs(monkeypatch, "fused_hybrid_pagerank")
    _submit(ingest, edges, n, 0)
    assert eng.step(force=True)
    # a walk index adds the stale count
    assert eng.metrics.batch_host_syncs == [
        BATCH + PACKED + seen[0] + 1 + (walks > 0)]
    assert np.isfinite(eng.store.snapshot().ranks.numpy()).all()
