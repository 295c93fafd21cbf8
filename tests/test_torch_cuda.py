"""Tests of the port that need the CUDA card (marked ``cuda``).

They skip where ``torch.cuda.is_available()`` is false.  This file imports
only the port, torch and numpy, so it also runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The SpMV kernel uses float atomics, so it is held to the plain version
at rtol 1e-4 / atol 1e-6 (f32 summation order), never bitwise.  The
walk-repair kernel has no atomics and no float sums: it is held to its
plain version bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.graph.dynamic import apply_batch, make_batch_update, \
    touched_vertices_mask
from repro_torch.graph.generators import random_batch_update, rmat_edges
from repro_torch.graph.structure import from_coo
from repro_torch.kernels.pagerank_spmv import pagerank_spmv as spmv
from repro_torch.kernels.pagerank_spmv.ref import frontier_spmv_ref_padded
from repro_torch.kernels.walk_repair import walk_repair as wr
from repro_torch.kernels.walk_repair.ref import resample_rows_ref
from repro_torch.ppr import IndexConfig, build_walk_index
from repro_torch.ppr.repair import stale_ids, stale_walks, walk_uniforms
from repro_torch.serve import IngestQueue, RankStore, ServeEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _packed(dev, be=512, vb=256, seed=11):
    edges, n = rmat_edges(10, 8, seed=seed)
    return spmv.pack_blocks(edges[:, 0], edges[:, 1],
                            np.ones(len(edges), bool), n, be=be, vb=vb,
                            spill_lanes_per_window=64, device=dev)


@pytest.mark.parametrize("frac", [0.0, 0.05, 1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, dtype, frac):
    packed = _packed(cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    nw, vb = packed.num_windows, packed.vb
    rsc = torch.rand(nw * vb, generator=gen, device=cuda).to(dtype)
    awin = torch.rand(nw, generator=gen, device=cuda) < frac
    before = spmv.LAUNCH_COUNTS["frontier_spmv"]
    out = spmv.frontier_spmv_padded(packed, rsc, awin)
    torch.cuda.synchronize()
    assert spmv.LAUNCH_COUNTS["frontier_spmv"] == before + 1
    ref = frontier_spmv_ref_padded(packed.src, packed.dst_rel, packed.valid,
                                   packed.window, rsc, awin, vb)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-6)
    assert bool((out[~awin.repeat_interleave(vb)] == 0).all())


def test_kernel_empty_graph_is_zero(cuda):
    none = np.zeros(0, np.int32)
    packed = spmv.pack_blocks(none, none, none.astype(bool), 1024, be=128,
                              vb=128, device=cuda)
    out = spmv.frontier_spmv_padded(
        packed, torch.ones(1024, device=cuda),
        torch.ones(packed.num_windows, dtype=torch.bool, device=cuda))
    assert float(out.abs().max()) == 0.0


def test_wrapper_checks_inputs(cuda):
    packed = _packed(cuda)
    v_pad = packed.num_windows * packed.vb
    awin = torch.ones(packed.num_windows, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError, match="rsc must be float32 or bfloat16"):
        spmv.frontier_spmv_padded(packed, torch.ones(
            v_pad, dtype=torch.float64, device=cuda), awin)
    with pytest.raises(ValueError, match="active_window"):
        spmv.frontier_spmv_padded(packed, torch.ones(v_pad, device=cuda),
                                  awin[:-1])
    with pytest.raises(ValueError, match="is on cpu"):
        spmv.frontier_spmv_padded(packed.to("cpu"),
                                  torch.ones(v_pad, device=cuda), awin)


def test_serve_engine_kernel_matches_xla_on_card(cuda):
    edges, n = rmat_edges(12, 8, seed=5)
    snaps, launches = {}, {}
    for name in ("kernel", "xla"):
        graph = from_coo(edges[:, 0], edges[:, 1], n, device=cuda)
        ingest = IngestQueue(flush_size=128, flush_interval=1e9,
                             device=cuda)
        store = RankStore()
        eng = ServeEngine(graph, ingest, store, engine=name)
        eng.bootstrap()
        before = spmv.LAUNCH_COUNTS["frontier_spmv"]
        for b in range(3):
            dele, ins = random_batch_update(edges, n, 128, seed=b)
            for u, v in dele:
                ingest.submit_delete(int(u), int(v))
            for u, v in ins:
                ingest.submit_insert(int(u), int(v))
            assert eng.step(force=True)
        launches[name] = spmv.LAUNCH_COUNTS["frontier_spmv"] - before
        snaps[name] = store.snapshot().ranks
    assert launches["kernel"] > 0 and launches["xla"] == 0
    assert float((snaps["kernel"] - snaps["xla"]).abs().max()) <= 1e-6


def _stale_inputs(dev, max_len=16):
    """The compacted stale walks of one 256-event batch on R-MAT scale 10:
    (new CSR, rows, first stale hops, uniforms), all on ``dev``."""
    edges, n = rmat_edges(10, 8, seed=7)
    graph = from_coo(edges[:, 0], edges[:, 1], n, device=dev)
    index = build_walk_index(graph, IndexConfig(num_walks=32,
                                                max_len=max_len, seed=1))
    dele, ins = random_batch_update(edges, n, 256, seed=2)
    update = make_batch_update(dele, ins, 256, 256, device=dev)
    csr = apply_batch(graph, update).to_device_csr()
    stale, t0 = stale_walks(index.steps, touched_vertices_mask(update, n))
    ids, t0_sel = stale_ids(stale, t0)
    rows = index.steps.view(-1, max_len)[ids]
    return csr, rows, t0_sel, walk_uniforms(index.key, ids, max_len)


@pytest.mark.parametrize("count", [1, 127, 129, None])
def test_walk_repair_kernel_matches_plain_bitwise(cuda, count):
    csr, rows, t0, u = _stale_inputs(cuda)
    assert rows.shape[0] > 129
    if count is not None:                 # None: every stale walk
        rows, t0, u = rows[:count], t0[:count], u[:count].contiguous()
    before = wr.LAUNCH_COUNTS["walk_repair"]
    out = wr.resample_rows(csr, rows, t0, u, alpha=0.85)
    torch.cuda.synchronize()
    assert wr.LAUNCH_COUNTS["walk_repair"] == before + 1
    assert torch.equal(out, resample_rows_ref(csr, rows, t0, u, alpha=0.85))


@pytest.mark.parametrize("max_len", [1, 2])
def test_walk_repair_kernel_short_walks(cuda, max_len):
    csr, rows, t0, u = _stale_inputs(cuda, max_len=max_len)
    before = wr.LAUNCH_COUNTS["walk_repair"]
    out = wr.resample_rows(csr, rows, t0, u, alpha=0.85)
    torch.cuda.synchronize()
    # a walk of one slot has no hop to re-walk: no launch
    assert wr.LAUNCH_COUNTS["walk_repair"] == before + (max_len > 1)
    assert torch.equal(out, resample_rows_ref(csr, rows, t0, u, alpha=0.85))


def test_walk_repair_wrapper_checks_inputs(cuda):
    csr, rows, t0, u = _stale_inputs(cuda)
    with pytest.raises(TypeError, match="t0 must be torch.int32"):
        wr.resample_rows(csr, rows, t0.long(), u, alpha=0.85)
    with pytest.raises(ValueError, match="u must have shape"):
        wr.resample_rows(csr, rows, t0, u[:, 1:], alpha=0.85)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        wr.resample_rows(csr, rows.t().contiguous().t(), t0, u, alpha=0.85)
    with pytest.raises(ValueError, match="deg is on cpu"):
        wr.resample_rows(csr._replace(deg=csr.deg.cpu()), rows, t0, u,
                         alpha=0.85)


def test_serve_engine_keeps_walk_index_on_card(cuda):
    edges, n = rmat_edges(12, 8, seed=5)
    graph = from_coo(edges[:, 0], edges[:, 1], n, device=cuda)
    ingest = IngestQueue(flush_size=128, flush_interval=1e9, device=cuda)
    cfg = IndexConfig(num_walks=16, max_len=12, seed=2)
    eng = ServeEngine(graph, ingest, RankStore(), engine="kernel",
                      ppr_index=cfg)
    eng.bootstrap()
    before = wr.LAUNCH_COUNTS["walk_repair"]
    for b in range(3):
        dele, ins = random_batch_update(edges, n, 128, seed=b)
        for u, v in dele:
            ingest.submit_delete(int(u), int(v))
        for u, v in ins:
            ingest.submit_insert(int(u), int(v))
        assert eng.step(force=True)
    snap = eng.store.snapshot()
    assert wr.LAUNCH_COUNTS["walk_repair"] > before
    assert eng.metrics.walks_resampled > 0
    fresh = build_walk_index(snap.graph, cfg)
    assert torch.equal(snap.ppr_index.steps, fresh.steps)
