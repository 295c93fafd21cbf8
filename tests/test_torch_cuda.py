"""Tests of the port that need the CUDA card (marked ``cuda``).

They skip where ``torch.cuda.is_available()`` is false.  This file
imports only the port, torch and numpy, so it also runs on a machine
without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The SpMV kernel sums in a fixed order, so it is bitwise equal from run to
run, but not in the plain version's order: rtol 1e-4 / atol 1e-6 (f32
summation order) against the plain version and against its split-order
plain version (``frontier_spmv_split_ref``).  Its split path (windows cut
into chunks of at most ``chunk_entries`` entries, partial rows summed by
a second pass) is forced at small K: 1, 2, 7 and the widest window.  The
walk-repair kernel makes its own threefry draws and has no atomics and no
float sums: it is held to its keyed plain version
(``resample_rows_keyed_ref``) bit for bit.  The f64 pull sum of the rank
loop (``pull_contrib``) cuts each vertex's terms into chunks of at most K
slots, adds each in slot order from +0.0, then the chunks in order: it is
held bit for bit to its plain version on the CPU at K = 1, 7 and
``PULL_CHUNK``, builds its chunk plan once an order, and the f64 loop on
the card is held to the loop on the CPU; the kernel engine's served ranks
are held bit for bit from run to run, and a batch's ``batch_host_syncs``
to ``torch.cuda.set_sync_debug_mode``'s count.  The segment-SpMM kernel
sums in a fixed order (bitwise equal from run to run) but not in the
order of the plain version's CUDA ``index_add_``: rtol 1e-4 / atol 1e-5
times the output's largest magnitude.  Its split path (windows cut into
chunks of at most ``chunk_entries`` entries, partial tiles summed by a
second pass) is forced at small K here: 1, 2, 7 and 64 entries a chunk.
The edge-slot count (``slot_count``: degrees and ``push_or``) sums
integers, so it equals its plain version exactly.  The weighted pull sum
is held bit for bit to its plain version on the CPU as the unweighted one
is, and the row sum of GraphSAGE (``pull_rows``: chunks of K slots, then
the chunks in order) bit for bit to its plain version on the CPU, and
within atol 1e-5 times its largest magnitude to the plain version on the
card.  The LM: a smoke config's gradients and train steps, dense
and MoE, f32 and bf16, bitwise run to run, and in f32 its loss and
gradients within the CPU tests' tolerance of the CPU's; chunked attention against a naive softmax in f32
(rtol 2e-4 / atol 2e-5, the reference's test) and bf16 (atol 2e-2: bf16
operands and probabilities); ``seg_sum`` on bf16 rows bitwise its plain
version on the CPU (the same f32 order, then one rounding).  DeepFM: a
train step at full widths on a cut vocabulary bitwise run to run and
within the CPU tests' tolerance of the CPU's, and ``pull_rows`` at its
table widths (d = 10 and 1) against its plain version.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.graph.dynamic import apply_batch, make_batch_update, \
    touched_vertices_mask
from repro_torch.graph.generators import random_batch_update, rmat_edges
from repro_torch.graph.structure import from_coo
from repro_torch.kernels.pagerank_spmv import pagerank_spmv as spmv
from repro_torch.kernels.pagerank_spmv.ref import frontier_spmv_ref_padded, \
    frontier_spmv_split_ref
from repro_torch.kernels.pagerank_spmv.update import apply_batch_packed, \
    pack_graph
from repro_torch.kernels.pull_contrib import pull_contrib as pc
from repro_torch.kernels.pull_contrib.ref import PULL_CHUNK, PullOrder, \
    pull_contrib_ref
from repro_torch.kernels.segment_ops import segment_matmul as sm
from repro_torch.kernels.segment_ops.ops import aggregate_features
from repro_torch.kernels.segment_ops.ref import gated_spmm_ref
from repro_torch.kernels.walk_repair import walk_repair as wr
from repro_torch.kernels.walk_repair.ref import resample_rows_keyed_ref
from repro_torch.ppr import IndexConfig, build_walk_index
from repro_torch.ppr.repair import stale_ids, stale_walks
from repro_torch.serve import IngestQueue, RankStore, ServeEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _tune_cache(tmp_path, monkeypatch):
    """The kernel engine tunes at bootstrap; its cache goes to tmp_path."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE",
                       str(tmp_path / "kernel_tune.json"))


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


def _spmv_split_pack(dev, kind):
    """``tail``: R-MAT scale 10 in entries of 64 lanes with 200 empty tail
    entries, which the last window owns; ``batched``: the same graph in
    entries of 16 lanes after two batches (overlay lanes out of dst
    order, holes from deletions)."""
    edges, n = rmat_edges(10, 8, seed=11)
    if kind == "tail":
        return spmv.pack_blocks(edges[:, 0], edges[:, 1],
                                np.ones(len(edges), bool), n, be=64, vb=256,
                                spill_lanes_per_window=64,
                                extra_entries=200, device=dev)
    graph = from_coo(edges[:, 0], edges[:, 1], n, device=dev)
    packed = pack_graph(graph, be=16, vb=32, spill_lanes_per_window=16,
                        extra_entries=3)
    for b in range(2):
        dele, ins = random_batch_update(edges, n, 32, seed=b)
        packed = apply_batch_packed(packed, make_batch_update(
            dele, ins, 32, 32, device=dev))
    return packed


def _spmv_inputs(packed, dtype, frac, seed=3):
    gen = torch.Generator(device=packed.device)
    gen.manual_seed(seed)
    nw, vb = packed.num_windows, packed.vb
    rsc = torch.rand(nw * vb, generator=gen, device=packed.device).to(dtype)
    awin = torch.rand(nw, generator=gen, device=packed.device) < frac
    return rsc, awin


def _check_spmv_call(packed, rsc, awin, k=spmv.CHUNK_ENTRIES):
    """One kernel call against both plain versions; inactive windows
    exactly 0; two more calls bitwise equal.  Returns the output."""
    before = spmv.LAUNCH_COUNTS["frontier_spmv"]
    out = spmv.frontier_spmv_padded(packed, rsc, awin, chunk_entries=k)
    torch.cuda.synchronize()
    assert spmv.LAUNCH_COUNTS["frontier_spmv"] == before + 1   # one a call
    torch.testing.assert_close(
        out, frontier_spmv_split_ref(packed, rsc, awin, k), rtol=1e-4,
        atol=1e-6)
    torch.testing.assert_close(
        out, frontier_spmv_ref_padded(packed.src, packed.dst_rel,
                                      packed.valid, packed.window, rsc, awin,
                                      packed.vb), rtol=1e-4, atol=1e-6)
    assert bool((out[~awin.repeat_interleave(packed.vb)] == 0).all())
    for _ in range(2):
        assert torch.equal(spmv.frontier_spmv_padded(
            packed, rsc, awin, chunk_entries=k), out)
    return out


@pytest.mark.parametrize("frac", [0.0, 0.4, 1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 7, "widest"])
@pytest.mark.parametrize("kind", ["tail", "batched"])
def test_kernel_split_matches_split_order_plain(cuda, kind, k, dtype, frac):
    packed = _spmv_split_pack(cuda, kind)
    owned = packed.entry_start[1:] - packed.entry_start[:-1]
    widest = int(owned.max())
    assert widest > 7
    k = widest if k == "widest" else k
    rsc, awin = _spmv_inputs(packed, dtype, frac)
    if frac == 0.4:
        awin[0] = awin[-1] = True      # the hub and the tail window
    _check_spmv_call(packed, rsc, awin, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_bitwise_deterministic(cuda, dtype):
    packed = _spmv_split_pack(cuda, "tail")
    rsc, awin = _spmv_inputs(packed, dtype, 1.0)
    first = spmv.frontier_spmv_padded(packed, rsc, awin)
    for _ in range(5):
        assert torch.equal(spmv.frontier_spmv_padded(packed, rsc, awin),
                           first)


@pytest.mark.parametrize("which", ["tail", "hub"])
@pytest.mark.parametrize("k", [1, 16])
def test_kernel_one_window_alone(cuda, which, k):
    # only the last window (the capacity tail) or only window 0, the
    # widest window of the graph itself
    packed = _spmv_split_pack(cuda, "tail")
    owned = (packed.entry_start[1:] - packed.entry_start[:-1]).cpu()
    hub = int(owned[:-1].argmax())
    assert int(owned[-1]) > 200 and int(owned[hub]) > 16
    rsc, _ = _spmv_inputs(packed, torch.float32, 1.0)
    awin = torch.zeros(packed.num_windows, dtype=torch.bool, device=cuda)
    awin[-1 if which == "tail" else hub] = True
    out = _check_spmv_call(packed, rsc, awin, k)
    assert float(out.abs().max()) > 0


@pytest.mark.parametrize("k", [1, 3])
def test_kernel_chunks_of_dead_lanes(cuda, k):
    # every lane of window 1's entries and of the tail's is dead: chunk 0
    # writes zeros, chunks 1.. flag their partials as holding no live lane
    packed = _spmv_split_pack(cuda, "tail")
    es = packed.entry_start.cpu()
    valid = packed.valid.clone()
    valid[int(es[1]):int(es[2])] = 0
    packed = dataclasses.replace(packed, valid=valid)
    assert int(es[2] - es[1]) > k
    rsc, awin = _spmv_inputs(packed, torch.float32, 1.0)
    out = _check_spmv_call(packed, rsc, awin, k)
    vb = packed.vb
    assert float(out[vb:2 * vb].abs().max()) == 0.0
    assert float(out[:vb].abs().max()) > 0


@pytest.mark.parametrize("k", [1, 16])
def test_kernel_empty_graph_with_tail_is_zero(cuda, k):
    none = np.zeros(0, np.int32)
    packed = spmv.pack_blocks(none, none, none.astype(bool), 1000, be=64,
                              vb=256, extra_entries=40, device=cuda)
    awin = torch.ones(packed.num_windows, dtype=torch.bool, device=cuda)
    out = _check_spmv_call(packed, torch.ones(packed.num_windows * 256,
                                              device=cuda), awin, k)
    assert float(out.abs().max()) == 0.0


def test_kernel_vb_limit_raises(cuda):
    wide = _packed(cuda, vb=2048)
    with pytest.raises(ValueError, match="vb 2048 outside"):
        spmv.frontier_spmv_padded(
            wide, torch.ones(wide.num_windows * 2048, device=cuda),
            torch.ones(wide.num_windows, dtype=torch.bool, device=cuda))
    # the geometries the engine and the tests use are inside it
    for vb in (16, 32, 64, 128, 256, 1024):
        packed = _packed(cuda, be=64, vb=vb)
        rsc, awin = _spmv_inputs(packed, torch.float32, 0.5)
        _check_spmv_call(packed, rsc, awin)


def test_kernel_info(cuda):
    packed = _spmv_split_pack(cuda, "tail")
    info = spmv.kernel_info(packed)
    assert info["chunk_entries"] == spmv.CHUNK_ENTRIES
    assert info["blocks_per_sm"] >= 1 and info["registers"] > 0
    assert info["smem_per_block"] == 8 * packed.vb * 4
    assert 0 < info["grid"] <= info["chunk_slots"]
    assert info["max_vb"] == 1024


def test_kernel_pagerank_loop_is_bitwise_run_to_run(cuda):
    from repro_torch.core.kernel_engine import kernel_pagerank_loop
    from repro_torch.core.pagerank import initial_affected, static_pagerank
    edges, n = rmat_edges(12, 8, seed=5)
    graph = from_coo(edges[:, 0], edges[:, 1], n, device=cuda)
    dele, ins = random_batch_update(edges, n, 256, seed=6)
    upd = make_batch_update(dele, ins, 256, 256, device=cuda)
    graph2 = apply_batch(graph, upd)
    packed = pack_graph(graph2, be=512, vb=256, spill_lanes_per_window=64,
                        extra_entries=50)
    ranks = static_pagerank(graph).ranks.to(torch.float32)
    aff = initial_affected(graph, graph2, touched_vertices_mask(upd, n))
    before = spmv.LAUNCH_COUNTS["frontier_spmv"]
    runs = [kernel_pagerank_loop(graph2, packed, ranks, aff)
            for _ in range(2)]
    assert spmv.LAUNCH_COUNTS["frontier_spmv"] - before == \
        sum(r.iterations for r in runs) > 2
    a, b = runs
    assert a.iterations == b.iterations
    assert torch.equal(a.ranks, b.ranks)
    assert torch.equal(a.affected_ever, b.affected_ever)
    assert torch.equal(a.delta, b.delta)
    assert int(a.edges_processed) == int(b.edges_processed)


def _stale_inputs(dev, max_len=16, seed=1):
    """The compacted stale walks of one 256-event batch on R-MAT scale 10:
    (new CSR, rows, first stale hops, the index's key, walk ids), all on
    ``dev``."""
    edges, n = rmat_edges(10, 8, seed=7)
    graph = from_coo(edges[:, 0], edges[:, 1], n, device=dev)
    index = build_walk_index(graph, IndexConfig(num_walks=32,
                                                max_len=max_len, seed=seed))
    dele, ins = random_batch_update(edges, n, 256, seed=2)
    update = make_batch_update(dele, ins, 256, 256, device=dev)
    csr = apply_batch(graph, update).to_device_csr()
    stale, t0 = stale_walks(index.steps, touched_vertices_mask(update, n))
    ids, t0_sel = stale_ids(stale, t0)
    rows = index.steps.view(-1, max_len)[ids]
    return csr, rows, t0_sel, index.key, ids


def _check_walk_repair(csr, rows, t0, key, ids, alpha=0.85):
    """One launch against the keyed plain version, bit for bit, and two
    more launches bitwise equal to it.  Returns the output."""
    before = wr.LAUNCH_COUNTS["walk_repair"]
    out = wr.resample_rows(csr, rows, t0, key, ids, alpha=alpha)
    torch.cuda.synchronize()
    assert wr.LAUNCH_COUNTS["walk_repair"] == before + (rows.shape[1] > 1)
    assert torch.equal(out, resample_rows_keyed_ref(csr, rows, t0, key, ids,
                                                    alpha=alpha))
    for _ in range(2):
        assert torch.equal(wr.resample_rows(csr, rows, t0, key, ids,
                                            alpha=alpha), out)
    return out


@pytest.mark.parametrize("count", [1, 127, 129, None])
def test_walk_repair_kernel_matches_plain_bitwise(cuda, count):
    csr, rows, t0, key, ids = _stale_inputs(cuda)
    assert rows.shape[0] > 129
    if count is not None:                 # None: every stale walk
        rows, t0, ids = rows[:count], t0[:count], ids[:count]
    out = _check_walk_repair(csr, rows, t0, key, ids)
    if count is None:
        assert not torch.equal(out, rows)


@pytest.mark.parametrize("max_len", [1, 2])
def test_walk_repair_kernel_short_walks(cuda, max_len):
    # a walk of one slot has no hop to re-walk: no launch
    _check_walk_repair(*_stale_inputs(cuda, max_len=max_len))


@pytest.mark.parametrize("alpha", [0.0, 0.85, 1.0])
@pytest.mark.parametrize("max_len", [16, 20, 33])
def test_walk_repair_kernel_walk_lengths(cuda, max_len, alpha):
    """Random first stale hops with 0 and L-1 among them, rows that start
    at -1, walk ids across 2**31 and 2**32 and a key with both words
    set; 1,000 walks, so the last warp's pool is short."""
    csr, rows, _, _, ids = _stale_inputs(cuda, max_len=max_len, seed=4)
    gen = torch.Generator(device=cuda).manual_seed(max_len)
    rows, ids = rows[:1000].clone(), ids[:1000]
    t0 = torch.randint(0, max_len, (1000,), generator=gen, device=cuda,
                       dtype=torch.int32)
    t0[:100], t0[100:200] = 0, max_len - 1
    rows[::13, 0] = -1
    for key in ((0, 3), (2, 5)):
        for offset in (0, 2**31 - 500, 2**32 - 500, 2**32 + 2**31):
            out = _check_walk_repair(csr, rows, t0, key, ids + offset,
                                     alpha=alpha)
    if alpha == 0.85:
        assert (out[:, -1] < 0).any() and not torch.equal(out, rows)


def test_walk_repair_kernel_large_pools(cuda):
    # R-MAT scale 14, 64 walks a vertex: tens of thousands of stale walks
    # over hundreds of blocks, bitwise and run to run
    edges, n = rmat_edges(14, 8, seed=9)
    graph = from_coo(edges[:, 0], edges[:, 1], n, device=cuda)
    index = build_walk_index(graph, IndexConfig(num_walks=64, max_len=16,
                                                seed=3))
    dele, ins = random_batch_update(edges, n, 1024, seed=5)
    update = make_batch_update(dele, ins, 1024, 1024, device=cuda)
    csr = apply_batch(graph, update).to_device_csr()
    stale, t0 = stale_walks(index.steps, touched_vertices_mask(update, n))
    ids, t0_sel = stale_ids(stale, t0)
    assert ids.shape[0] > 20_000
    _check_walk_repair(csr, index.steps.view(-1, 16)[ids], t0_sel,
                       index.key, ids)


def test_walk_repair_wrapper_checks_inputs(cuda):
    csr, rows, t0, key, ids = _stale_inputs(cuda)
    with pytest.raises(TypeError, match="t0 must be torch.int32"):
        wr.resample_rows(csr, rows, t0.long(), key, ids, alpha=0.85)
    with pytest.raises(TypeError, match="ids must be torch.int64"):
        wr.resample_rows(csr, rows, t0, key, ids.int(), alpha=0.85)
    with pytest.raises(ValueError, match="ids must have shape"):
        wr.resample_rows(csr, rows, t0, key, ids[1:], alpha=0.85)
    with pytest.raises(ValueError, match="ids is on cpu"):
        wr.resample_rows(csr, rows, t0, key, ids.cpu(), alpha=0.85)
    with pytest.raises(ValueError, match="two uint32 words"):
        wr.resample_rows(csr, rows, t0, (1, -1), ids, alpha=0.85)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        wr.resample_rows(csr, rows.t().contiguous().t(), t0, key, ids,
                         alpha=0.85)
    with pytest.raises(ValueError, match="deg is on cpu"):
        wr.resample_rows(csr._replace(deg=csr.deg.cpu()), rows, t0, key,
                         ids, alpha=0.85)
    long_rows = torch.zeros((4, wr.MAX_LEN + 1), dtype=torch.int32,
                            device=cuda)
    with pytest.raises(ValueError, match="exceed the kernel"):
        wr.resample_rows(csr, long_rows, t0[:4], key, ids[:4], alpha=0.85)


def test_walk_repair_kernel_info(cuda):
    info = wr.kernel_info(16)
    assert info["registers"] > 0 and info["blocks_per_sm"] >= 1
    assert info["max_len"] == wr.MAX_LEN
    assert info["smem_per_block"] == info["walks_per_block"] * 17 * 4
    assert wr.kernel_info(wr.MAX_LEN)["blocks_per_sm"] >= 1


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


# ---------------------------------------------------------------------------
# gated segment-SpMM (GNN aggregation)
# ---------------------------------------------------------------------------

def _spmm_inputs(dev, d, frac, seed=11, vb=256):
    packed = _packed(dev, vb=vb, seed=seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    feats = torch.randn(packed.num_vertices, d, generator=gen, device=dev)
    awin = torch.rand(packed.num_windows, generator=gen, device=dev) < frac
    return packed, feats, awin


def _spmm_plain(packed, feats, awin):
    return gated_spmm_ref(packed.src, packed.dst_rel, packed.valid,
                          packed.window, feats, awin, packed.num_vertices,
                          packed.vb)


def _assert_spmm_close(out, ref):
    scale = max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("d", [16, 130, 602])
@pytest.mark.parametrize("frac", [0.0, 0.05, 1.0])
def test_gated_spmm_kernel_matches_plain(cuda, frac, d):
    packed, feats, awin = _spmm_inputs(cuda, d, frac)
    before = sm.LAUNCH_COUNTS["gated_spmm"]
    out = sm.gated_spmm(packed, feats, awin)
    torch.cuda.synchronize()
    assert sm.LAUNCH_COUNTS["gated_spmm"] == before + 1
    assert out.shape == (packed.num_vertices, d)
    _assert_spmm_close(out, _spmm_plain(packed, feats, awin))
    inactive = ~awin.repeat_interleave(packed.vb)[:packed.num_vertices]
    assert bool((out[inactive] == 0).all())


def test_gated_spmm_kernel_is_deterministic(cuda):
    packed, feats, awin = _spmm_inputs(cuda, 130, 1.0)
    first = sm.gated_spmm(packed, feats, awin)
    for _ in range(3):
        assert torch.equal(sm.gated_spmm(packed, feats, awin), first)


def test_gated_spmm_kernel_empty_graph_is_zero(cuda):
    none = np.zeros(0, np.int32)
    packed = spmv.pack_blocks(none, none, none.astype(bool), 1000, be=128,
                              vb=256, device=cuda)
    out = aggregate_features(packed, torch.ones(1000, 37, device=cuda),
                             torch.ones(1000, dtype=torch.bool, device=cuda))
    torch.cuda.synchronize()
    assert out.shape == (1000, 37) and float(out.abs().max()) == 0.0


def test_gated_spmm_kernel_hub_window(cuda):
    # every vertex points at vertex 3: window 0 owns 64 entries of 128 lanes
    n = 8192
    rng = np.random.default_rng(0)
    other = rng.integers(0, n, size=(20000, 2))
    src = np.concatenate([np.arange(4, n), other[:, 0]])
    dst = np.concatenate([np.full(n - 4, 3), other[:, 1]])
    packed = spmv.pack_blocks(src, dst, np.ones(len(src), bool), n, be=128,
                              vb=256, device=cuda)
    assert packed.max_entries_per_window >= 64
    feats = torch.randn(n, 130, device=cuda)
    awin = torch.ones(packed.num_windows, dtype=torch.bool, device=cuda)
    out = sm.gated_spmm(packed, feats, awin)
    _assert_spmm_close(out, _spmm_plain(packed, feats, awin))


def _split_inputs(dev, d, frac, seed=11):
    """Entries of 64 lanes and 5 tail entries: windows own 20-70 entries,
    the last window the tail too."""
    edges, n = rmat_edges(10, 8, seed=seed)
    packed = spmv.pack_blocks(edges[:, 0], edges[:, 1],
                              np.ones(len(edges), bool), n, be=64, vb=256,
                              spill_lanes_per_window=64, extra_entries=5,
                              device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    feats = torch.randn(n, d, generator=gen, device=dev)
    awin = torch.rand(packed.num_windows, generator=gen, device=dev) < frac
    awin[0] = True                               # the widest window
    return packed, feats, awin


def _check_split_call(packed, feats, awin, k):
    before = sm.LAUNCH_COUNTS["gated_spmm"]
    out = sm.gated_spmm(packed, feats, awin, chunk_entries=k)
    torch.cuda.synchronize()
    assert sm.LAUNCH_COUNTS["gated_spmm"] == before + 1    # one per call
    _assert_spmm_close(out, _spmm_plain(packed, feats, awin))
    inactive = ~awin.repeat_interleave(packed.vb)[:packed.num_vertices]
    assert bool((out[inactive] == 0).all())
    for _ in range(2):
        assert torch.equal(sm.gated_spmm(packed, feats, awin,
                                         chunk_entries=k), out)
    return out


@pytest.mark.parametrize("k", [1, 2, 7, 64, "widest"])
@pytest.mark.parametrize("d", [16, 33, 130, 602])
def test_gated_spmm_kernel_split_matches_plain(cuda, d, k):
    packed, feats, awin = _split_inputs(cuda, d, 0.6)
    owned = packed.entry_start[1:] - packed.entry_start[:-1]
    widest = int(owned.max())
    assert widest > 7
    if k == "widest":
        k = widest                      # no window splits
    _check_split_call(packed, feats, awin, k)


@pytest.mark.parametrize("k", [1, 7, 64])
def test_gated_spmm_kernel_split_after_batch(cuda, k):
    # lanes claimed through the overlay are no longer dst-sorted
    edges, n = rmat_edges(10, 8, seed=5)
    graph = from_coo(edges[:, 0], edges[:, 1], n, device=cuda)
    packed = pack_graph(graph, be=16, vb=32, spill_lanes_per_window=16,
                        extra_entries=3)
    dele, ins = random_batch_update(edges, n, 16, seed=k)
    upd = make_batch_update(dele, ins, 16, 16, device=cuda)
    packed = apply_batch_packed(packed, upd)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(k)
    feats = torch.randn(n, 130, generator=gen, device=cuda)
    awin = packed.active_windows(touched_vertices_mask(upd, n))
    assert bool(awin.any()) and not bool(awin.all())
    _check_split_call(packed, feats, awin, k)


@pytest.mark.parametrize("k", [1, 64])
def test_gated_spmm_kernel_split_empty_graph(cuda, k):
    none = np.zeros(0, np.int32)
    packed = spmv.pack_blocks(none, none, none.astype(bool), 1000, be=64,
                              vb=256, extra_entries=9, device=cuda)
    awin = torch.ones(packed.num_windows, dtype=torch.bool, device=cuda)
    out = _check_split_call(packed, torch.ones(1000, 37, device=cuda),
                            awin, k)
    assert float(out.abs().max()) == 0.0


def test_gated_spmm_kernel_unaligned_features(cuda):
    # X one float past an 8-byte boundary: the kernel copies 4 B a thread
    packed, feats, awin = _split_inputs(cuda, 130, 0.6)
    flat = torch.empty(feats.numel() + 1, device=cuda)
    flat[1:] = feats.reshape(-1)
    shifted = flat[1:].view(feats.shape)
    assert shifted.data_ptr() % 8 == 4
    out = _check_split_call(packed, shifted, awin, 7)
    assert torch.equal(out, sm.gated_spmm(packed, feats, awin,
                                          chunk_entries=7))


def test_gated_spmm_kernel_skips_dead_lanes(cuda):
    # `valid` is 0 or 1, so the kernel skips a dead lane where the plain
    # version adds 0 * X[src]: the two differ only for non-finite X
    packed, feats, awin = _split_inputs(cuda, 130, 0.6)
    n = packed.num_vertices
    dead = packed.valid == 0
    assert bool((dead & awin[packed.window.long()][:, None]).any())
    # every dead lane reads an extra row of NaN past the vertices
    packed = dataclasses.replace(packed, src=torch.where(dead, n, packed.src))
    nan_row = torch.full((1, 130), float("nan"), device=cuda)
    with_nan = torch.cat([feats, nan_row])
    out = sm.gated_spmm(packed, with_nan, awin, chunk_entries=7)
    assert bool(torch.isfinite(out).all())
    assert torch.equal(sm.gated_spmm(packed, with_nan, awin,
                                     chunk_entries=7), out)
    with_zero = torch.cat([feats, torch.zeros_like(nan_row)])
    _assert_spmm_close(out, _spmm_plain(packed, with_zero, awin))
    assert bool(_spmm_plain(packed, with_nan, awin).isnan().any())


def test_gated_spmm_kernel_info(cuda):
    packed, _, _ = _split_inputs(cuda, 602, 1.0)
    info = sm.kernel_info(packed, 602)
    assert info["blocks_per_sm"] >= 1 and info["registers"] > 0
    assert info["smem_per_block"] >= 0 and info["lanes_in_flight"] >= 1
    assert info["scratch_bytes"] == sm.scratch_bytes(packed, 602)
    assert info["scratch_bytes_used"] == sm.scratch_bytes_used(packed, 602)
    assert 0 < info["scratch_bytes_used"] < info["scratch_bytes"]


def test_gated_spmm_wrapper_checks_inputs(cuda):
    packed, feats, awin = _spmm_inputs(cuda, 16, 1.0)
    with pytest.raises(ValueError, match="feats must be contiguous"):
        sm.gated_spmm(packed, feats.t().contiguous().t(), awin)
    with pytest.raises(ValueError, match="active_window must have shape"):
        sm.gated_spmm(packed, feats, awin[:-1])
    with pytest.raises(TypeError, match="active_window must be torch.bool"):
        sm.gated_spmm(packed, feats, awin.int())
    with pytest.raises(ValueError, match="src is on cpu"):
        sm.gated_spmm(dataclasses.replace(packed, src=packed.src.cpu()),
                      feats, awin)
    wide = _packed(cuda, vb=2048)
    with pytest.raises(ValueError, match="vb 2048 outside"):
        sm.gated_spmm(wide, torch.ones(wide.num_vertices, 4, device=cuda),
                      torch.ones(wide.num_windows, dtype=torch.bool,
                                 device=cuda))


def test_gnn_refresh_on_card(cuda):
    from repro_torch.configs.graphsage_reddit import SMOKE as cfg
    from repro_torch.core.incremental_gnn import incremental_refresh
    from repro_torch.models.gnn import GraphBatch, init_sage, sage_forward
    edges, n = rmat_edges(10, 8, seed=3)
    dele, ins = random_batch_update(edges, n, 64, seed=4)
    feats = np.random.default_rng(5).standard_normal(
        (n, cfg.d_in)).astype(np.float32)
    params = init_sage(cfg, torch.Generator().manual_seed(0))
    old = {}
    for dev in ("cpu", cuda):
        p = params.to(dev)
        x = torch.from_numpy(feats).to(dev)

        def fwd(g, h):
            return sage_forward(cfg, p, GraphBatch(
                h, g.src, g.dst, g.valid,
                torch.ones(n, dtype=torch.bool, device=dev)))
        graph = from_coo(edges[:, 0], edges[:, 1], n, device=dev)
        old[str(dev)] = fwd(graph, x)
    # the forward on the card against the CPU's
    scale = float(old["cpu"].abs().max())
    torch.testing.assert_close(old[str(cuda)].cpu(), old["cpu"], rtol=1e-4,
                               atol=1e-5 * scale)
    # the refresh on the card: exact on what it refreshed, work skipped
    upd = make_batch_update(dele, ins, 64, 64, device=cuda)
    graph2 = apply_batch(graph, upd)
    res = incremental_refresh(graph2, x, old[str(cuda)],
                              touched_vertices_mask(upd, n), layer_fn=fwd,
                              n_layers=cfg.n_layers)
    full = fwd(graph2, x)
    ever = res.affected_ever
    torch.testing.assert_close(res.embeddings[ever], full[ever], rtol=1e-4,
                               atol=1e-5 * scale)
    assert res.nodes_recomputed.device.type == "cuda"
    assert 0 < int(res.nodes_recomputed) < n


# ---------------------------------------------------------------------------
# the f64 loop's fixed-order pull sum, and the rank path run to run
# ---------------------------------------------------------------------------

def _pull_inputs(dev, kind):
    """(order, ranks, inv_deg) on ``dev`` for R-MAT scale 18 after a batch
    (``rmat``), a 300,000-edge hub among random edges (``hub``), or a graph
    with no live edge (``dead``); the same seeded values on every
    device."""
    rng = np.random.default_rng(11)
    if kind == "hub":
        n = 400_000
        src = np.concatenate([rng.permutation(n)[:300_000],
                              rng.integers(0, n, 500_000)])
        dst = np.concatenate([np.full(300_000, 7), rng.integers(0, n, 500_000)])
        keep = src != dst
        graph = from_coo(src[keep], dst[keep], n, device=dev)
    else:
        edges, n = rmat_edges(18, 8, seed=13)
        graph = from_coo(edges[:, 0], edges[:, 1], n, device=dev)
        dele, ins = random_batch_update(edges, n, 4096, seed=14)
        graph = apply_batch(graph, make_batch_update(dele, ins, 4096, 4096,
                                                     device=dev))
        if kind == "dead":
            graph = dataclasses.replace(graph,
                                        valid=torch.zeros_like(graph.valid))
    ranks = torch.from_numpy(rng.random(n) / n).to(dev)
    inv = 1.0 / graph.out_degree(include_self_loop=True).to(torch.float64)
    order = pc.pull_order(graph.src, graph.dst, graph.valid,
                          graph.num_vertices)
    return order, ranks, inv


@pytest.mark.parametrize("k", [1, 7, PULL_CHUNK])
@pytest.mark.parametrize("kind", ["rmat", "hub", "dead"])
def test_pull_contrib_kernel_equals_cpu_sum_bitwise(cuda, kind, k):
    order, ranks, inv = _pull_inputs(cuda, kind)
    before = pc.LAUNCH_COUNTS["pull_contrib"]
    out = pc.pull_contrib(order, ranks, inv, chunk_slots=k)
    torch.cuda.synchronize()
    assert pc.LAUNCH_COUNTS["pull_contrib"] == before + 1
    # the contract: chunks of at most k slots, each added in slot order
    # from +0.0, then the chunks in order, as the CPU's plain version adds
    cpu = pull_contrib_ref(PullOrder(*(t.cpu() for t in order)),
                           ranks.cpu(), inv.cpu(), chunk_slots=k)
    assert torch.equal(out.cpu(), cpu)
    for _ in range(3):
        assert torch.equal(pc.pull_contrib(order, ranks, inv,
                                           chunk_slots=k), out)
    # the plain version on the card adds with atomics: close, not equal
    torch.testing.assert_close(out, pull_contrib_ref(order, ranks, inv,
                                                     chunk_slots=k),
                               rtol=1e-12, atol=0)
    if kind == "dead":
        assert float(out.abs().max()) == 0.0
    if kind == "hub":
        assert int(order.ptr[8] - order.ptr[7]) >= 299_999


def test_pull_contrib_builds_its_plan_once_an_order(cuda, monkeypatch):
    """The chunk plan is built at the first call on an order's ``ptr`` and
    handed back on every later one (the f64 loop makes one order a solve):
    no second build, and the same result bit for bit."""
    from repro_torch.kernels.segment_ops import plan as plan_mod
    order, ranks, inv = _pull_inputs(cuda, "rmat")
    builds = []

    def counted(*args):
        builds.append(args[1:])
        return chunk_plan(*args)
    chunk_plan = plan_mod.chunk_plan
    monkeypatch.setattr(plan_mod, "chunk_plan", counted)
    out = pc.pull_contrib(order, ranks, inv)
    assert len(builds) == 1
    for _ in range(3):
        assert torch.equal(pc.pull_contrib(order, ranks, inv), out)
    assert torch.equal(pc.pull_values(order, ranks * inv), out)
    assert len(builds) == 1
    # another K is another plan; a new order (a new ptr) another again
    pc.pull_contrib(order, ranks, inv, chunk_slots=64)
    pc.pull_contrib(order._replace(ptr=order.ptr.clone()), ranks, inv)
    assert len(builds) == 3


def test_pull_contrib_wrapper_checks_inputs(cuda):
    order, ranks, inv = _pull_inputs(cuda, "dead")
    with pytest.raises(TypeError, match="ranks must be torch.float64"):
        pc.pull_contrib(order, ranks.float(), inv)
    with pytest.raises(ValueError, match="inv_deg is on cpu"):
        pc.pull_contrib(order, ranks, inv.cpu())
    with pytest.raises(ValueError, match="ptr must have shape"):
        pc.pull_contrib(order._replace(ptr=order.ptr[1:]), ranks, inv)
    with pytest.raises(ValueError, match="inv_deg must have shape"):
        pc.pull_contrib(order, ranks, inv[1:])
    with pytest.raises(TypeError, match="ptr must be torch.int32"):
        pc.pull_contrib(order._replace(ptr=order.ptr.long()), ranks, inv)
    info = pc.kernel_info()
    assert info["registers"] > 0 and info["blocks_per_sm"] >= 1


@pytest.mark.parametrize("method", ["static", "frontier_prune"])
def test_f64_loop_on_card_equals_cpu_bitwise(cuda, method):
    from repro_torch.core import pagerank as pr
    edges, n = rmat_edges(14, 8, seed=5)
    dele, ins = random_batch_update(edges, n, 256, seed=6)
    runs = {}
    for dev in ("cpu", cuda):
        graph = from_coo(edges[:, 0], edges[:, 1], n, device=dev)
        upd = make_batch_update(dele, ins, 256, 256, device=dev)
        graph2 = apply_batch(graph, upd)
        if method == "static":
            runs[str(dev)] = pr.static_pagerank(graph2)
        else:
            prev = pr.static_pagerank(graph).ranks
            runs[str(dev)] = pr.dynamic_frontier_prune_pagerank(
                graph, graph2, touched_vertices_mask(upd, n), prev)
    a, b = runs["cpu"], runs[str(cuda)]
    assert a.iterations == b.iterations
    assert torch.equal(a.ranks, b.ranks.cpu())
    assert torch.equal(a.affected_ever, b.affected_ever.cpu())


def _serve_feed(eng, ingest, edges, n, b, size=512):
    dele, ins = random_batch_update(edges, n, size, seed=100 + b)
    for u, v in dele:
        ingest.submit_delete(int(u), int(v))
    for u, v in ins:
        ingest.submit_insert(int(u), int(v))
    return eng.step(force=True)


def test_serve_engine_rank_path_is_bitwise_run_to_run(cuda):
    edges, n = rmat_edges(16, 8, seed=5)
    snaps, iters = [], []
    for _ in range(2):
        graph = from_coo(edges[:, 0], edges[:, 1], n, device=cuda)
        ingest = IngestQueue(flush_size=512, flush_interval=1e9, device=cuda)
        eng = ServeEngine(graph, ingest, RankStore(), engine="kernel")
        eng.bootstrap()
        for b in range(3):
            assert _serve_feed(eng, ingest, edges, n, b)
        snaps.append(eng.store.snapshot().ranks)
        iters.append(list(eng.metrics.batch_iterations))
    assert eng.metrics.static_fallbacks == 0
    assert iters[0] == iters[1]
    assert torch.equal(snaps[0], snaps[1])


def _sync_sites(syncs):
    import collections
    import os
    return dict(collections.Counter(
        f"{os.path.basename(w.filename)}:{w.lineno}" for w in syncs))


@pytest.mark.parametrize("engine,walks", [("kernel", 0), ("xla", 0),
                                          ("kernel", 16)])
def test_rank_step_host_syncs_match_sync_debug_mode(cuda, engine, walks):
    """``batch_host_syncs`` of a served batch equals the synchronizing
    calls ``torch.cuda.set_sync_debug_mode("warn")`` reports for it."""
    import warnings
    edges, n = rmat_edges(16, 8, seed=5)
    graph = from_coo(edges[:, 0], edges[:, 1], n, device=cuda)
    ingest = IngestQueue(flush_size=512, flush_interval=1e9, device=cuda)
    ppr = IndexConfig(num_walks=walks, max_len=12, seed=2) if walks else None
    eng = ServeEngine(graph, ingest, RankStore(), engine=engine,
                      ppr_index=ppr)
    eng.bootstrap()
    assert _serve_feed(eng, ingest, edges, n, 0)     # the first batch warms
    for b in (1, 2):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                assert _serve_feed(eng, ingest, edges, n, b)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # only the warning that names a synchronizing call: the first
        # switch into the mode also warns that it is a prototype
        syncs = [w for w in caught if "called a synchronizing CUDA "
                 "operation" in str(w.message)]
        m = eng.metrics
        assert m.static_fallbacks == 0 and m.packed_rebuilds == 0
        assert m.batch_host_syncs[-1] == len(syncs), _sync_sites(syncs)


# ---------------------------------------------------------------------------
# the edge-slot count, the weighted pull sum and the row sum
# ---------------------------------------------------------------------------

def _count_graph(dev, kind):
    """R-MAT scale 18 after a batch (``rmat``: dead and 1.5x free slots),
    a 300,000-edge hub among random edges (``hub``), or only free slots
    (``free``); the same seeded graph on every device."""
    if kind == "free":
        e = np.zeros((0, 2), np.int32)
        return from_coo(e[:, 0], e[:, 1], 1000, edge_capacity=100_000,
                        device=dev)
    rng = np.random.default_rng(11)
    if kind == "hub":
        n = 400_000
        src = np.concatenate([rng.permutation(n)[:300_000],
                              rng.integers(0, n, 500_000)])
        dst = np.concatenate([np.full(300_000, 7),
                              rng.integers(0, n, 500_000)])
        keep = src != dst
        return from_coo(src[keep], dst[keep], n, device=dev)
    edges, n = rmat_edges(18, 8, seed=13)
    graph = from_coo(edges[:, 0], edges[:, 1], n, device=dev)
    dele, ins = random_batch_update(edges, n, 4096, seed=14)
    return apply_batch(graph, make_batch_update(dele, ins, 4096, 4096,
                                                device=dev))


@pytest.mark.parametrize("kind", ["rmat", "hub", "free"])
@pytest.mark.parametrize("gathered", [False, True])
def test_slot_count_kernel_equals_plain(cuda, kind, gathered):
    from repro_torch.kernels.slot_count import slot_count as sc
    from repro_torch.kernels.slot_count.ref import slot_count_ref
    g = _count_graph(cuda, kind)
    n = g.num_vertices
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    flags = torch.rand(n, generator=gen, device=cuda) < 0.3
    extra = (g.src, flags) if gathered else ()
    for index in (g.src, g.dst):
        before = sc.LAUNCH_COUNTS["slot_count"]
        out = sc.slot_count(index, g.valid, n, *extra)
        torch.cuda.synchronize()
        assert sc.LAUNCH_COUNTS["slot_count"] == before + 1
        assert torch.equal(out, slot_count_ref(index, g.valid, n, *extra))
        cpu = slot_count_ref(index.cpu(), g.valid.cpu(), n,
                             *(t.cpu() for t in extra))
        assert torch.equal(out.cpu(), cpu)
        assert torch.equal(sc.slot_count(index, g.valid, n, *extra), out)


def test_slot_count_wrapper_checks_inputs(cuda):
    from repro_torch.kernels.slot_count import slot_count as sc
    g = _count_graph(cuda, "free")
    with pytest.raises(TypeError, match="weight must be torch.bool"):
        sc.slot_count(g.dst, g.valid.int(), g.num_vertices)
    with pytest.raises(TypeError, match="index must be torch.int32"):
        sc.slot_count(g.dst.long(), g.valid, g.num_vertices)
    with pytest.raises(ValueError, match="flags is on cpu"):
        sc.slot_count(g.dst, g.valid, g.num_vertices, g.src,
                      torch.zeros(g.num_vertices, dtype=torch.bool))


@pytest.mark.parametrize("kind", ["rmat", "hub", "dead"])
def test_weighted_pull_contrib_kernel_equals_cpu_sum_bitwise(cuda, kind):
    order, ranks, inv = _pull_inputs(cuda, kind)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(8)
    w = torch.rand(order.src.shape[0], generator=gen, device=cuda,
                   dtype=torch.float64) + 0.5
    before = pc.LAUNCH_COUNTS["pull_contrib"]
    out = pc.pull_contrib(order, ranks, inv, w)
    torch.cuda.synchronize()
    assert pc.LAUNCH_COUNTS["pull_contrib"] == before + 1
    cpu = pull_contrib_ref(PullOrder(*(t.cpu() for t in order)),
                           ranks.cpu(), inv.cpu(), w.cpu())
    assert torch.equal(out.cpu(), cpu)
    for _ in range(2):
        assert torch.equal(pc.pull_contrib(order, ranks, inv, w), out)
    torch.testing.assert_close(out, pull_contrib_ref(order, ranks, inv, w),
                               rtol=1e-12, atol=0)
    # weight 1 is the unweighted kernel's sum, bit for bit
    assert torch.equal(pc.pull_contrib(order, ranks, inv,
                                       torch.ones_like(w)),
                       pc.pull_contrib(order, ranks, inv))
    with pytest.raises(ValueError, match="weight must have shape"):
        pc.pull_contrib(order, ranks, inv, w[1:])


@pytest.mark.parametrize("d,k", [(602, 64), (128, 64), (37, 3), (5, 1)])
def test_pull_rows_kernel_equals_cpu_sum_bitwise(cuda, d, k):
    from repro_torch.kernels.pull_contrib.ref import pull_rows_ref
    from repro_torch.models.gnn import neighbor_order
    g = _count_graph(cuda, "hub" if k == 64 else "rmat")
    n = g.num_vertices
    order = neighbor_order(g.src, g.dst, g.valid, n)
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    xc = x.to(cuda)
    before = pc.LAUNCH_COUNTS["pull_rows"]
    out = pc.pull_rows(order, xc, chunk_slots=k)
    torch.cuda.synchronize()
    assert pc.LAUNCH_COUNTS["pull_rows"] == before + 1
    cpu = pull_rows_ref(PullOrder(*(t.cpu() for t in order)), x,
                        chunk_slots=k)
    assert torch.equal(out.cpu(), cpu)
    for _ in range(2):
        assert torch.equal(pc.pull_rows(order, xc, chunk_slots=k), out)
    # the plain version on the card adds with atomics: close, not equal
    plain = pull_rows_ref(order, xc, chunk_slots=k)
    scale = float(plain.abs().max())
    assert float((out - plain).abs().max()) <= 1e-5 * scale
    info = pc.kernel_info()
    assert info["row_registers"] > 0 and info["row_blocks_per_sm"] >= 1


@pytest.mark.parametrize("rows", [1, 7])
def test_pull_values_kernel_equals_cpu_sum_bitwise(cuda, rows):
    """Sums keyed by vertex whose values are shorter than V (``rows``
    positions a value, as the PPR visit counts take them) and the segment
    sum: kernel == the CPU's plain sum, bit for bit, run to run."""
    n, m = 50_000, 300_000
    rng = np.random.default_rng(rows)
    keys = rng.integers(-1, n, m).astype(np.int32)
    keys[: m // 4] = 3                              # a hub of keys
    values = torch.from_numpy(rng.random(m // rows + 1))
    w = torch.from_numpy(rng.random(m) + 0.5)
    outs = {}
    for dev in ("cpu", cuda):
        k = torch.from_numpy(keys).to(dev)
        live = k >= 0
        ptr, perm, _ = pc.sorted_slots(k, live, n)
        order = PullOrder(ptr, torch.div(perm, rows, rounding_mode="floor")
                          .to(torch.int32))
        before = pc.LAUNCH_COUNTS["pull_contrib"]
        outs[dev] = (pc.pull_values(order, values.to(dev)),
                     pc.pull_values(order, values.to(dev), w.to(dev)[perm]),
                     pc.segment_sum(ptr, w.to(dev)[perm]))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert pc.LAUNCH_COUNTS["pull_contrib"] == before + 3
            again = (pc.pull_values(order, values.to(dev)),
                     pc.pull_values(order, values.to(dev), w.to(dev)[perm]),
                     pc.segment_sum(ptr, w.to(dev)[perm]))
            assert all(torch.equal(a, b) for a, b in zip(again, outs[dev]))
            with pytest.raises(TypeError, match="ranks must be torch.float64"):
                pc.pull_values(order, values.to(dev).float())
    for a, b in zip(outs[cuda], outs["cpu"]):
        assert a.shape == (n,) and torch.equal(a.cpu(), b)


# ---------------------------------------------------------------------------
# pull_rows' hot rows kept in L2, and its vector paths
# ---------------------------------------------------------------------------

def _rows_case(dev, d, kind="rmat", offset=0):
    """(order, x on ``dev``, x on the CPU) for ``_count_graph(kind)`` and
    seeded f32 features; with ``offset`` x and the order's src are
    contiguous views that start ``offset`` elements into their storage."""
    from repro_torch.models.gnn import neighbor_order
    g = _count_graph(dev, kind)
    n = g.num_vertices
    order = neighbor_order(g.src, g.dst, g.valid, n)
    if offset:
        order = order._replace(src=torch.cat(
            [order.src.new_zeros(offset), order.src])[offset:])
    rows = np.random.default_rng(d).standard_normal((n, d)).astype(
        np.float32)
    flat = np.concatenate([np.zeros(offset, np.float32), rows.ravel()])
    x = torch.from_numpy(flat).to(dev)[offset:].view(n, d)
    return order, x, torch.from_numpy(rows)


@pytest.mark.parametrize("d,kind", [(602, "rmat"), (602, "hub"),
                                    (128, "hub"), (128, "rmat"),
                                    (37, "rmat"), (37, "hub")])
def test_pull_rows_hot_budgets_equal_bitwise(cuda, d, kind):
    """Budget 0 (no hot row), a partial hot set and every source hot give
    the same sums bit for bit, equal to the CPU's plain version: the cache
    policy moves no add."""
    from repro_torch.kernels.pull_contrib.ref import pull_rows_ref
    order, x, xc = _rows_case(cuda, d, kind)
    cpu = pull_rows_ref(PullOrder(*(t.cpu() for t in order)), xc)
    n = x.shape[0]
    outs = []
    for budget in (0, 4 * d * 1000, 4 * d * n):
        hot = pc.cached_hot_set(order, n, d, budget)
        held = int(hot.hot.sum())
        assert held <= budget // (4 * d)
        if budget:
            assert held > 0 and bool((hot.tag < 0).any())
        before = pc.LAUNCH_COUNTS["pull_rows"]
        out = pc.pull_rows(order, x, hot_bytes=budget)
        torch.cuda.synchronize()
        assert pc.LAUNCH_COUNTS["pull_rows"] == before + 1
        assert torch.equal(pc.pull_rows(order, x, hot_bytes=budget), out)
        outs.append(out)
    for out in outs:
        assert torch.equal(out.cpu(), cpu)


@pytest.mark.parametrize("d", [602, 128, 64, 37, 5, 1030, 1024])
def test_pull_rows_vector_paths_equal_scalar_path(cuda, d):
    """The float2 and float4 paths (chosen from d and x's address; 1030
    and 1024 take two passes) against the scalar path, which a view one
    float into its storage (4-byte aligned) takes: bitwise equal, and
    equal to the CPU's sum."""
    from repro_torch.kernels.pull_contrib.ref import pull_rows_ref
    order, x, xc = _rows_case(cuda, d, "hub")
    order1, x1, _ = _rows_case(cuda, d, "hub", offset=1)
    assert torch.equal(x1, x) and x1.data_ptr() % 8 == 4
    assert torch.equal(order1.src, order.src)
    assert order1.src.data_ptr() % 16 == 4     # the tag launch's scalar loop
    assert pc.row_path(d, x1.data_ptr()) == (1, 8)
    want = {602: (2, 10), 1030: (2, 10), 128: (4, 1), 64: (4, 1),
            1024: (4, 1)}.get(d, (1, 8))
    assert pc.row_path(d, x.data_ptr()) == want
    out = pc.pull_rows(order, x)
    assert torch.equal(pc.pull_rows(order, x1), out)
    assert torch.equal(pc.pull_rows(order1, x1), out)
    cpu = pull_rows_ref(PullOrder(*(t.cpu() for t in order)), xc)
    assert torch.equal(out.cpu(), cpu)
    paths = pc.kernel_info()["row_paths"]
    assert set(paths) == {f"{v}x{k}" for v, k in pc.ROW_PATHS.items()}
    assert all(r > 0 and b >= 1 for r, b in paths.values())


def test_pull_rows_hot_set_cached_per_order(cuda, monkeypatch):
    """sage_forward's two layers (d_in and d_hidden) build the sources'
    ranking once for their one order, and a hot set a width; a later call
    on the order builds nothing."""
    from repro_torch.configs.graphsage_reddit import CONFIG as cfg
    from repro_torch.models import gnn
    from repro_torch.models.gnn import GraphBatch, init_sage, sage_forward
    g = _count_graph(cuda, "rmat")
    n = g.num_vertices
    built = {"ranking": 0, "hot_set": 0}

    def counting(name, fn):
        def call(*a, **kw):
            built[name] += 1
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(pc, "source_ranking",
                        counting("ranking", pc.source_ranking))
    monkeypatch.setattr(pc, "hot_set", counting("hot_set", pc.hot_set))
    orders, neighbor_order = [], gnn.neighbor_order

    def recording(*a):
        orders.append(neighbor_order(*a))
        return orders[-1]
    monkeypatch.setattr(gnn, "neighbor_order", recording)
    params = init_sage(cfg, torch.Generator(device=cuda).manual_seed(0))
    x = torch.randn(n, cfg.d_in, generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    every = torch.ones(n, dtype=torch.bool, device=cuda)
    sage_forward(cfg, params, GraphBatch(x, g.src, g.dst, g.valid, every))
    assert len(orders) == 1
    # d_in and d_hidden hold different numbers of rows in the budget
    assert built == {"ranking": 1, "hot_set": cfg.n_layers}
    pc.pull_rows(orders[0], x)
    assert built == {"ranking": 1, "hot_set": cfg.n_layers}


# ---------------------------------------------------------------------------
# the counts by dst over the dst-sorted order: segment_bounds, segment_or
# ---------------------------------------------------------------------------

def _segment_graph(dev, kind):
    """``_count_graph``'s kinds, and: every slot live (``full``), no live
    slot (``dead``), and in-edges only to vertices 1 .. n - 51, so vertex
    0 and the last 50 have none (``gaps``); the same seeded graph on every
    device."""
    if kind in ("rmat", "hub", "free"):
        return _count_graph(dev, kind)
    rng = np.random.default_rng(23)
    n = 70_001
    if kind == "gaps":
        src = rng.integers(0, n, 400_003)
        dst = rng.integers(1, n - 50, 400_003)
        return from_coo(src, dst, n, dedup=False, device=dev)
    edges, n = rmat_edges(16, 8, seed=17)
    full = from_coo(edges[:, 0], edges[:, 1], n,
                    edge_capacity=len(edges), device=dev)
    if kind == "full":
        return full
    return dataclasses.replace(full, valid=torch.zeros_like(full.valid))


@pytest.mark.parametrize("kind", ["rmat", "hub", "free", "full", "dead",
                                  "gaps"])
def test_segment_bounds_kernel_equals_plain(cuda, kind):
    from repro_torch.kernels.slot_count import slot_count as sc
    from repro_torch.kernels.slot_count.ref import segment_bounds_ref, \
        slot_count_ref
    g = _segment_graph(cuda, kind)
    n = g.num_vertices
    keys, perm = torch.sort(torch.where(g.valid, g.dst, n), stable=True)
    before = sc.LAUNCH_COUNTS["segment_bounds"]
    ptr = sc.segment_bounds(keys, n)
    torch.cuda.synchronize()
    assert sc.LAUNCH_COUNTS["segment_bounds"] == before + 1
    assert ptr.dtype == torch.int32 and ptr.shape == (n + 1,)
    assert torch.equal(ptr, segment_bounds_ref(keys, n))
    assert torch.equal(ptr.cpu(), segment_bounds_ref(keys.cpu(), n))
    # the cumsum of the atomic count by dst, and run to run
    counts = slot_count_ref(g.dst, g.valid, n).long()
    assert torch.equal(ptr[1:].long(), torch.cumsum(counts, 0))
    assert int(ptr[0]) == 0 and int(ptr[n]) == int(g.valid.sum())
    assert torch.equal(sc.segment_bounds(keys, n), ptr)
    # the order's perm is the old argsort's
    assert torch.equal(perm, torch.argsort(torch.where(g.valid, g.dst, n),
                                           stable=True))


@pytest.mark.parametrize("frac", [0.0, 0.01, 0.5, 1.0])
@pytest.mark.parametrize("kind", ["rmat", "hub", "free", "full", "dead",
                                  "gaps"])
def test_segment_or_kernel_equals_plain(cuda, kind, frac):
    from repro_torch.kernels.slot_count import slot_count as sc
    from repro_torch.kernels.slot_count.ref import segment_or_ref, \
        slot_count_ref
    g = _segment_graph(cuda, kind)
    n = g.num_vertices
    order = pc.pull_order(g.src, g.dst, g.valid, n)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    flags = torch.rand(n, generator=gen, device=cuda) < frac
    before = sc.LAUNCH_COUNTS["segment_or"]
    out = sc.segment_or(order.ptr, order.src, order.dst, flags)
    torch.cuda.synchronize()
    assert sc.LAUNCH_COUNTS["segment_or"] == before + 1
    assert out.dtype == torch.bool and out.shape == (n,)
    assert torch.equal(out, segment_or_ref(order.ptr, order.src, order.dst,
                                           flags))
    cpu = segment_or_ref(*(t.cpu() for t in (order.ptr, order.src,
                                             order.dst, flags)))
    assert torch.equal(out.cpu(), cpu)
    assert torch.equal(out, slot_count_ref(g.dst, g.valid, n, g.src,
                                           flags) > 0)
    assert torch.equal(g.push_or(flags), out)
    assert torch.equal(sc.segment_or(order.ptr, order.src, order.dst,
                                     flags), out)


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("tail", [1, 2, 3, 4])
def test_segment_kernels_unaligned_views_and_tail(cuda, offset, tail):
    """Keys, sources and sorted dst that start ``offset`` int32 into their
    storage (scalar loads), and orders whose length leaves ``tail`` slots
    past the last 16-byte group."""
    from repro_torch.kernels.slot_count import slot_count as sc
    from repro_torch.kernels.slot_count.ref import segment_bounds_ref, \
        segment_or_ref
    g = _segment_graph(cuda, "gaps")
    n = g.num_vertices
    order = pc.pull_order(g.src, g.dst, g.valid, n)
    live = int(order.ptr[n])
    E = (live // 4) * 4 - 4 + tail
    assert E <= live                    # the tail is live

    def shifted(t):
        return torch.cat([t.new_zeros(offset), t[:E]])[offset:]
    keys, src = shifted(order.dst), shifted(order.src)
    assert keys.data_ptr() % 16 != 0 and keys.shape == (E,)
    ptr = sc.segment_bounds(keys, n)
    assert torch.equal(ptr, segment_bounds_ref(keys, n))
    assert torch.equal(ptr, sc.segment_bounds(order.dst[:E].clone(), n))
    flags = torch.rand(n, generator=torch.Generator(device=cuda)
                       .manual_seed(offset), device=cuda) < 0.3
    for s, d in ((src, keys), (src, order.dst[:E].clone()),
                 (order.src[:E].clone(), order.dst[:E].clone())):
        assert torch.equal(sc.segment_or(ptr, s, d, flags),
                           segment_or_ref(ptr, s, d, flags))
    # flags whose length is no multiple of 32, from an unaligned base
    m = n + 7
    odd = torch.cat([flags.new_zeros(offset), flags,
                     flags[:7]])[offset:]
    assert odd.shape == (m,)
    assert torch.equal(sc.segment_or(ptr, src, keys, odd),
                       segment_or_ref(ptr, src, keys, odd))


def test_segment_wrappers_check_inputs(cuda):
    from repro_torch.kernels.slot_count import slot_count as sc
    g = _segment_graph(cuda, "gaps")
    n = g.num_vertices
    order = pc.pull_order(g.src, g.dst, g.valid, n)
    flags = torch.zeros(n, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError, match="keys must be torch.int32"):
        sc.segment_bounds(order.dst.long(), n)
    with pytest.raises(ValueError, match="keys must be contiguous"):
        sc.segment_bounds(order.dst[::2], n)
    with pytest.raises(TypeError, match="flags must be torch.bool"):
        sc.segment_or(order.ptr, order.src, order.dst, flags.int())
    with pytest.raises(ValueError, match="flags is on cpu"):
        sc.segment_or(order.ptr, order.src, order.dst, flags.cpu())
    with pytest.raises(ValueError, match="dst must have shape"):
        sc.segment_or(order.ptr, order.src, order.dst[1:], flags)
    with pytest.raises(TypeError, match="ptr must be torch.int32"):
        sc.segment_or(order.ptr.long(), order.src, order.dst, flags)


def test_served_kernel_batch_builds_one_order(cuda):
    """A steady served batch of the kernel engine sorts its new graph once
    (its old graph's order is the previous batch's), counts its
    out-degrees once, writes one ``ptr`` and ORs every ``push_or`` over
    the order: no count by dst, and no second order."""
    from repro_torch.graph import structure
    from repro_torch.kernels.slot_count import slot_count as sc
    edges, n = rmat_edges(16, 8, seed=5)
    graph = from_coo(edges[:, 0], edges[:, 1], n, device=cuda)
    ingest = IngestQueue(flush_size=512, flush_interval=1e9, device=cuda)
    eng = ServeEngine(graph, ingest, RankStore(), engine="kernel")
    eng.bootstrap()
    assert _serve_feed(eng, ingest, edges, n, 0)     # the first batch warms
    for b in (1, 2):
        builds = dict(structure.CACHE_BUILDS)
        launches = dict(sc.LAUNCH_COUNTS)
        assert _serve_feed(eng, ingest, edges, n, b)
        torch.cuda.synchronize()
        built = {k: structure.CACHE_BUILDS[k] - builds.get(k, 0)
                 for k in ("pull_order", "out_degree")}
        ran = {k: sc.LAUNCH_COUNTS[k] - launches.get(k, 0)
               for k in ("slot_count", "segment_bounds", "segment_or")}
        assert built == {"pull_order": 1, "out_degree": 1}, built
        assert ran["slot_count"] == 1 and ran["segment_bounds"] == 1, ran
        assert ran["segment_or"] >= 2, ran     # initial_affected's two
    assert eng.metrics.static_fallbacks == 0


# ---------------------------------------------------------------------------
# observability: the digest, the monitor's syncs, the shadow's stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["ranks", "negzero_nan_subnormal", "wrap"])
def test_rank_digest_on_card_equals_cpu(cuda, case):
    """torch's int64 multiply and sum wrap the same way on the card as on
    the CPU (where the digest is held to the reference's)."""
    from repro_torch.obs import rank_digest
    rng = np.random.default_rng(3)
    r = rng.random(1 << 20)
    if case == "negzero_nan_subnormal":
        bits = r.view(np.int64)
        r[5] = -0.0
        r[6] = np.nextafter(0.0, 1.0)
        bits[7] = np.int64(0x7FF8000000000001)
    elif case == "wrap":
        r[:] = 1e308
    cpu = torch.from_numpy(r.copy())
    assert rank_digest(cpu.to(cuda)) == rank_digest(cpu)


def _monitored(cuda, edges, n, **kw):
    from repro_torch.obs import CorrectnessMonitor, MonitorConfig
    graph = from_coo(edges[:, 0], edges[:, 1], n, device=cuda)
    ingest = IngestQueue(flush_size=512, flush_interval=1e9, device=cuda)
    mon = CorrectnessMonitor(MonitorConfig(**kw)) if kw else None
    eng = ServeEngine(graph, ingest, RankStore(), engine="kernel",
                      telemetry=bool(kw), monitor=mon)
    eng.bootstrap()
    return eng, ingest


def test_monitored_step_host_syncs_match_sync_debug_mode(cuda):
    """With the monitor (shadow synchronous, an anchor every 2 batches)
    and telemetry on, ``batch_host_syncs`` still equals the debug mode's
    count; the snapshots equal the unmonitored run's bit for bit."""
    import warnings
    from repro_torch.obs import rank_digest
    edges, n = rmat_edges(16, 8, seed=5)
    digests = {}
    for monitored in (False, True):
        kw = dict(shadow_every=2, anchor_every=2,
                  shadow_background=False) if monitored else {}
        eng, ingest = _monitored(cuda, edges, n, **kw)
        out = []
        for b in range(4):
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    assert _serve_feed(eng, ingest, edges, n, b)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = [w for w in caught if "called a synchronizing CUDA "
                     "operation" in str(w.message)]
            assert eng.metrics.batch_host_syncs[-1] == len(syncs), \
                _sync_sites(syncs)
            out.append(rank_digest(eng.store.snapshot().ranks))
        digests[monitored] = out
        if monitored:
            assert eng.monitor.incidents == []
            assert eng.monitor.shadow.samples == 2
            assert eng.last_telemetry.iterations == \
                eng.metrics.batch_iterations[-1]
        eng.close()
    assert digests[True] == digests[False]


def test_background_shadow_on_its_own_stream_keeps_snapshots(cuda):
    """A shadow solve on its own stream, every batch, leaves the hot
    path's snapshots bitwise those of an unmonitored run, and its reports
    within the reference's budgets."""
    from repro_torch.obs import rank_digest
    edges, n = rmat_edges(16, 8, seed=5)
    digests = {}
    for monitored in (False, True):
        kw = dict(shadow_every=1) if monitored else {}
        eng, ingest = _monitored(cuda, edges, n, **kw)
        digests[monitored] = []
        for b in range(4):
            assert _serve_feed(eng, ingest, edges, n, b)
            digests[monitored].append(
                rank_digest(eng.store.snapshot().ranks))
        eng.close()
        if monitored:
            sv = eng.monitor.shadow
            assert sv._stream is not None
            assert sv.samples >= 1 and sv.samples + sv.skipped == 4
            assert all(r.l1 <= 1e-4 and r.linf <= 1e-5 for r in sv.reports)
            assert eng.monitor.incidents == []
    assert digests[True] == digests[False]


def test_monitored_bundle_replays_bitwise_on_card(cuda, tmp_path):
    from repro_torch.obs import CorrectnessMonitor, MonitorConfig, replay
    edges, n = rmat_edges(14, 8, seed=5)
    graph = from_coo(edges[:, 0], edges[:, 1], n, device=cuda)
    ingest = IngestQueue(flush_size=512, flush_interval=1e9, device=cuda)
    mon = CorrectnessMonitor(MonitorConfig(
        shadow_every=0, anchor_every=2, incident_dir=str(tmp_path)))
    eng = ServeEngine(graph, ingest, RankStore(), engine="kernel",
                      monitor=mon)
    eng.bootstrap()
    top = int(torch.argmax(eng.store.snapshot().ranks))
    eng.inject_fault(2, kind="rank", vertex=top, scale=1e4)
    for b in range(4):
        assert _serve_feed(eng, ingest, edges, n, b)
    eng.close()
    errors = [i for i in mon.incidents if i.severity == "error"]
    assert errors and errors[0].kind == "rank_mass"
    assert errors[0].generation == 2
    report = replay(mon.last_bundle, device=cuda)
    assert report.ok, report.describe()


# ---------------------------------------------------------------------------
# the replica tier, the iteration budget and block-Gauss-Seidel
# ---------------------------------------------------------------------------

def _debug_syncs(fn):
    """(fn(), the synchronizing calls set_sync_debug_mode reports)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [w for w in caught if "called a synchronizing CUDA "
                 "operation" in str(w.message)]


@pytest.mark.parametrize("engine", ["kernel", "xla"])
def test_replica_bitwise_on_card_and_hook_syncs_counted(cuda, engine):
    """A writer on the card and a replica on the card through a faulty
    transport: the replica's ranks equal the writer's bit for bit; the
    writer's hook runs inside the step and its reads are counted there."""
    from repro_torch.ft.elastic import ReplicaRoster
    from repro_torch.serve import FaultyTransport, LogicalClock, \
        ReadReplica, ReplicationWriter
    edges, n = rmat_edges(16, 8, seed=5)
    clock = LogicalClock()
    transport = FaultyTransport(seed=1, drop_p=0.2)
    roster = ReplicaRoster(heartbeat_timeout=1e9)
    graph = from_coo(edges[:, 0], edges[:, 1], n, device=cuda)
    ingest = IngestQueue(flush_size=512, flush_interval=1e9, device=cuda,
                         clock=clock)
    eng = ServeEngine(graph, ingest, RankStore(), engine=engine,
                      clock=clock)
    eng.bootstrap()
    w = ReplicationWriter(eng, transport, anchor_every=2, clock=clock)
    w.attach()
    transport.set_writer(w)
    r = ReadReplica("r0", transport, n, roster=roster, clock=clock,
                    device=cuda, backoff_base=0.01)
    assert r.bootstrap()
    for b in range(4):
        clock.advance(0.1)
        ok, syncs = _debug_syncs(lambda: _serve_feed(eng, ingest, edges, n,
                                                     b))
        assert ok
        if b > 0:
            assert eng.metrics.batch_host_syncs[-1] == len(syncs), \
                _sync_sites(syncs)
        w.heartbeat(roster)
        r.pump()
    for _ in range(40):
        clock.advance(0.1)
        w.heartbeat(roster)
        r.pump()
    assert r.generation == eng.store.generation == 4
    assert r.ranks.device.type == "cuda"
    assert torch.equal(r.ranks, eng.store.snapshot().ranks)
    assert torch.equal(r.graph.src, eng.store.snapshot().graph.src)


def test_edge_diff_touched_on_card_equals_cpu(cuda):
    from repro_torch.serve.replicate import _edge_diff_touched
    edges, n = rmat_edges(14, 8, seed=3)
    out = {}
    for dev in ("cpu", cuda):
        g0 = from_coo(edges[:, 0], edges[:, 1], n, device=dev)
        dele, ins = random_batch_update(edges, n, 2048, seed=4)
        g1 = apply_batch(g0, make_batch_update(dele, ins, 2048, 2048,
                                               device=dev))
        out[str(dev)] = _edge_diff_touched(g0, g1, n).cpu()
    assert out["cpu"].any()
    assert torch.equal(out["cpu"], out["cuda"])


@pytest.mark.parametrize("engine", ["kernel", "xla"])
def test_budget_host_syncs_match_sync_debug_mode(cuda, engine):
    """With ``iteration_budget=2`` (capped solves that read their delta,
    and a carried frontier), ``batch_host_syncs`` equals the debug mode's
    count on every batch."""
    edges, n = rmat_edges(16, 8, seed=5)
    graph = from_coo(edges[:, 0], edges[:, 1], n, device=cuda)
    ingest = IngestQueue(flush_size=512, flush_interval=1e9, device=cuda)
    # no static fallback (as the reference's budget test): a carried
    # frontier seeds a capped dynamic solve
    eng = ServeEngine(graph, ingest, RankStore(), engine=engine,
                      iteration_budget=2, static_fallback_frac=2.0)
    eng.bootstrap()
    assert _serve_feed(eng, ingest, edges, n, 0)     # the first batch warms
    for b in (1, 2, 3):
        ok, syncs = _debug_syncs(lambda: _serve_feed(eng, ingest, edges, n,
                                                     b))
        assert ok
        assert eng.metrics.batch_host_syncs[-1] == len(syncs), \
            _sync_sites(syncs)
    assert eng.metrics.budget_carryover >= 1
    assert eng.metrics.static_fallbacks == 0
    assert max(eng.metrics.batch_iterations) <= \
        (4 if engine == "kernel" else 2)


def test_gauss_seidel_bitwise_run_to_run_on_card(cuda):
    from repro_torch.core.gauss_seidel import gauss_seidel_pagerank
    edges, n = rmat_edges(14, 8, seed=23)
    out = []
    for dev in (cuda, cuda, "cpu"):
        g = from_coo(edges[:, 0], edges[:, 1], n, device=dev)
        p = spmv.pack_blocks(edges[:, 0], edges[:, 1],
                             np.ones(len(edges), bool), n, be=512, vb=256,
                             device=dev)
        out.append(gauss_seidel_pagerank(
            g, p, torch.full((n,), 1.0 / n, device=dev), tol=1e-7))
    assert out[0].sweeps == out[1].sweeps
    assert torch.equal(out[0].ranks, out[1].ranks)
    assert torch.equal(out[0].delta, out[1].delta)
    # the card's segment sums add in another order than the CPU's
    assert abs(out[0].sweeps - out[2].sweeps) <= 1
    assert float((out[0].ranks.cpu() - out[2].ranks).abs().max()) <= 1e-6


# ---------------------------------------------------------------------------
# the geometry tuner and the sharded engines on the card
# ---------------------------------------------------------------------------

def test_tuner_keys_its_cache_by_the_card_name(cuda, tmp_path):
    from repro_torch.kernels.pagerank_spmv import tune
    edges, n = rmat_edges(14, 8, seed=3)
    graph = from_coo(edges[:, 0], edges[:, 1], n, device=cuda)
    path = str(tmp_path / "t.json")
    geom, info = tune.tune_geometry(graph, cache_path=path, measure=True,
                                    measure_top=2)
    name = torch.cuda.get_device_name(0).replace(" ", "_")
    assert tune.device_kind(cuda) == name and info.key.startswith(name + "/")
    assert info.source == "measured"
    timed = [c for c in info.candidates if c[2] is not None]
    assert len(timed) == 2 and all(t > 0 for _, _, t in timed)
    again, hit = tune.tune_geometry(graph, cache_path=path)
    assert hit.cache_hit and again == geom
    # the kernel, not its plain version: use_kernel=True runs on the card
    assert tune._measure(graph, geom, 0.05, True, repeats=1) > 0


def _sharded_serve(dev, edges, n, mesh, batches=3, **kernel_opts):
    from repro_torch.kernels.pagerank_spmv.pagerank_spmv import \
        LAUNCH_COUNTS
    graph = from_coo(edges[:, 0], edges[:, 1], n, device=dev)
    ingest = IngestQueue(flush_size=512, flush_interval=1e9, device=dev)
    eng = ServeEngine(graph, ingest, RankStore(), engine="kernel",
                      mesh=mesh, static_fallback_frac=1.0,
                      kernel_opts=dict(be=512, vb=256, **kernel_opts))
    eng.bootstrap()
    snaps, launches, iters = [], [], []
    for b in range(batches):
        before = LAUNCH_COUNTS["frontier_spmv"]
        assert _serve_feed(eng, ingest, edges, n, b)
        launches.append(LAUNCH_COUNTS["frontier_spmv"] - before)
        if eng._sharded is not None:
            iters.append(eng._sharded.last_comm_info["f32_iterations"])
        snaps.append(eng.store.snapshot().ranks.clone())
    return eng, snaps, launches, iters


@pytest.mark.parametrize("exchange", ["halo", "psum"])
def test_four_shards_on_one_card_match_unsharded(cuda, exchange):
    """Four shards of the kernel engine on cuda:0 (the mesh repeats the
    card): L∞ <= 1e-6 of the unsharded kernel engine every batch, one
    frontier_spmv launch a shard an f32 iteration, bitwise run to run."""
    from repro_torch.launch.mesh import make_test_mesh
    edges, n = rmat_edges(16, 8, seed=5)
    mesh = make_test_mesh(4, device=cuda, model=4)
    assert all(d.type == cuda.type for d in mesh.devices.flat)
    _, plain, _, _ = _sharded_serve(cuda, edges, n, None)
    eng, snaps, launches, iters = _sharded_serve(cuda, edges, n, mesh,
                                                 exchange=exchange)
    assert eng._sharded.num_shards == 4
    assert all(p.device.type == cuda.type
               for p in eng._sharded.sharded.shards)
    for got, want in zip(snaps, plain):
        assert float((got - want).abs().max()) <= 1e-6
    assert launches == [4 * it for it in iters] and min(iters) > 0
    _, again, _, _ = _sharded_serve(cuda, edges, n, mesh, exchange=exchange)
    assert all(torch.equal(a, b) for a, b in zip(snaps, again))


@pytest.mark.parametrize("engine,exchange", [("kernel", "halo"),
                                             ("kernel", "psum"),
                                             ("xla", "halo")])
def test_mesh_step_host_syncs_match_sync_debug_mode(cuda, engine, exchange):
    from repro_torch.launch.mesh import make_test_mesh
    edges, n = rmat_edges(15, 8, seed=5)
    mesh = make_test_mesh(4, device=cuda,
                          model=4 if engine == "kernel" else 2)
    graph = from_coo(edges[:, 0], edges[:, 1], n, device=cuda)
    ingest = IngestQueue(flush_size=512, flush_interval=1e9, device=cuda)
    eng = ServeEngine(graph, ingest, RankStore(), engine=engine, mesh=mesh,
                      static_fallback_frac=1.0,
                      kernel_opts=dict(exchange=exchange))
    eng.bootstrap()
    assert _serve_feed(eng, ingest, edges, n, 0)
    for b in (1, 2):
        ok, syncs = _debug_syncs(
            lambda: _serve_feed(eng, ingest, edges, n, b))
        assert ok
        assert eng.metrics.batch_host_syncs[-1] == len(syncs), \
            _sync_sites(syncs)


def test_forced_repack_on_card_names_shards(cuda):
    from repro_torch.launch.mesh import make_test_mesh
    edges, n = rmat_edges(15, 8, seed=5)
    mesh = make_test_mesh(4, device=cuda, model=4)
    eng, snaps, _, _ = _sharded_serve(cuda, edges, n, mesh, batches=2,
                                      delta_budget=8)
    m = eng.metrics
    assert m.packed_rebuilds == 2
    assert set(m.packed_rebuilds_by_shard) <= {0, 1, 2, 3}
    assert bool(torch.isfinite(snaps[-1]).all())


@pytest.mark.parametrize("shards", [2, 4])
def test_shard_spmv_kernel_equals_plain_on_full_width_rsc(cuda, shards):
    """Each shard's frontier_spmv launch on the inputs the sharded loops
    give it: an rsc spanning every vertex (src is global; all of it set,
    as the psum exchange has it, or only the shard's range and its halo,
    as the halo exchange's buffer) and the shard's own windows.  Held to
    the plain version at rtol 1e-4 / atol 1e-6, one launch a call."""
    from repro_torch.kernels.pagerank_spmv.pagerank_spmv import \
        LAUNCH_COUNTS
    from repro_torch.kernels.pagerank_spmv.shard import build_halo, \
        frontier_spmv_shard, pack_shards
    edges, n = rmat_edges(15, 8, seed=7)
    graph = from_coo(edges[:, 0], edges[:, 1], n, device=cuda)
    sharded, spec = pack_shards(graph, shards, be=256, vb=128,
                                spill_lanes_per_window=16,
                                devices=[cuda] * shards)
    halo = build_halo(sharded, spec)
    wps, vps = spec.windows_per_shard, spec.vertices_per_shard
    gen = torch.Generator(device=cuda)
    gen.manual_seed(shards)
    full = torch.rand(spec.padded_vertices, generator=gen, device=cuda)
    for s, p in enumerate(sharded.shards):
        part = torch.zeros_like(full)
        part[s * vps:(s + 1) * vps] = full[s * vps:(s + 1) * vps]
        ids = halo.ids[s].long().to(cuda)
        ids = ids[ids < spec.padded_vertices]
        part[ids] = full[ids]
        for frac in (0.05, 1.0):
            awin = torch.rand(wps, generator=gen, device=cuda) < frac
            for rsc in (full, part):
                before = LAUNCH_COUNTS["frontier_spmv"]
                out = frontier_spmv_shard(p, rsc, awin)
                assert LAUNCH_COUNTS["frontier_spmv"] == before + 1
                ref = frontier_spmv_ref_padded(p.src, p.dst_rel, p.valid,
                                               p.window, rsc, awin, p.vb)
                torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-6)
                assert not out[~awin.repeat_interleave(p.vb)].any()


def test_use_kernel_false_is_refused_on_card(cuda):
    """On the card every frontier_spmv call launches the kernel: the
    plain version (``use_kernel=False``) is refused for CUDA tensors and
    for a kernel engine on a CUDA graph."""
    edges, n = rmat_edges(10, 8, seed=1)
    graph = from_coo(edges[:, 0], edges[:, 1], n, device=cuda)
    packed = pack_graph(graph, be=256, vb=128, spill_lanes_per_window=16)
    awin = torch.ones(packed.num_windows, dtype=torch.bool, device=cuda)
    rsc = torch.ones(n, device=cuda)
    with pytest.raises(ValueError, match="use_kernel=False"):
        spmv.frontier_spmv_padded(packed, rsc, awin, use_kernel=False)
    with pytest.raises(ValueError, match="use_kernel=False"):
        ServeEngine(graph, IngestQueue(flush_size=16, device=cuda),
                    RankStore(), engine="kernel",
                    kernel_opts=dict(use_kernel=False))


# ---------------------------------------------------------------------------
# the training primitives, a SAGE train step, the sharded walk index
# ---------------------------------------------------------------------------

def _prim_inputs(dev, n=300, e=5000, d=24, seed=0):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, n, e).astype(np.int32)).to(dev)
    vals = torch.from_numpy(rng.standard_normal((e, d)).astype(
        np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(
        np.float32)).to(dev)
    return idx, vals, x


@pytest.mark.parametrize("prim", ["seg_sum", "edge_gather", "seg_max",
                                  "neighbor_sum"])
def test_training_primitives_on_card(cuda, prim):
    """Forward and backward of each primitive on the card: bitwise run to
    run, the sums launched through pull_rows, and within atol 1e-5 times
    the largest magnitude of the same primitive on the CPU."""
    from repro_torch.models import message
    n = 300
    idx, vals, x = _prim_inputs(cuda)
    src = torch.flip(idx, (0,)).contiguous()
    mask = torch.arange(idx.shape[0], device=cuda) % 5 != 0

    def run(dev):
        i, s, m = idx.to(dev), src.to(dev), mask.to(dev)
        arg = (x if prim in ("edge_gather", "neighbor_sum") else vals)
        a = arg.to(dev).clone().requires_grad_()
        out = {"seg_sum": lambda: message.seg_sum(a, i, n),
               "edge_gather": lambda: message.edge_gather(a, i),
               "seg_max": lambda: message.seg_max(a, i, n),
               "neighbor_sum": lambda: message.neighbor_sum(a, s, i, m,
                                                            n)}[prim]()
        g = torch.linspace(-1, 1, out.numel(), device=dev).reshape(
            out.shape)
        (grad,) = torch.autograd.grad(out, a, g)
        return out.detach(), grad
    before = pc.LAUNCH_COUNTS["pull_rows"]
    out, grad = run(cuda)
    assert pc.LAUNCH_COUNTS["pull_rows"] > before
    out2, grad2 = run(cuda)
    assert torch.equal(out, out2) and torch.equal(grad, grad2)
    ref_out, ref_grad = run("cpu")
    for a, b in ((out, ref_out), (grad, ref_grad)):
        fin = torch.isfinite(b)
        torch.testing.assert_close(a.cpu()[fin], b[fin], rtol=1e-5,
                                   atol=1e-5 * float(b[fin].abs().max()))


def test_sage_train_step_bitwise_on_card(cuda):
    """A SAGE train step at a small size, twice from the same state:
    loss, gradients and updated parameters bitwise; within the CPU
    tests' tolerance of the same step on the CPU."""
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.optim.adamw import init_adamw
    from repro_torch.train import inputs as TI
    from repro_torch.train import steps as TS
    spec = REGISTRY["graphsage-reddit"]
    results = {}
    for dev, tag in ((cuda, "a"), (cuda, "b"), ("cpu", "cpu")):
        for cell in ("full_graph_sm", "minibatch_lg"):
            cfg = TI.effective_config(spec, spec.shapes[cell], True)
            batch = TI.build_inputs(spec, spec.shapes[cell], concrete=True,
                                    smoke=True, seed=1, device=dev)
            params = TI.init_fn(spec, True)(
                torch.Generator().manual_seed(0)).to(dev)
            loss_fn = TS.make_gnn_loss(spec.arch_id, cfg)
            loss, grads = TS.value_and_grad(loss_fn, params, batch)
            step = TS.make_gnn_train_step(spec.arch_id, cfg)
            opt = init_adamw(params)
            losses = []
            for _ in range(3):
                params, opt, l3 = step(params, opt, batch)
                losses.append(l3)
            results[tag, cell] = ([loss] + grads + losses
                                  + [p.detach() for p in params.leaves()])
    for cell in ("full_graph_sm", "minibatch_lg"):
        for a, b, c in zip(results["a", cell], results["b", cell],
                           results["cpu", cell]):
            assert torch.equal(a, b)
            torch.testing.assert_close(
                a.cpu().double(), c.double(), rtol=1e-4,
                atol=1e-5 * float(c.abs().max()) + 1e-30)


def test_four_shard_walk_index_on_card(cuda):
    """A four-shard walk index on cuda:0 equals the unsharded one, built
    and repaired; one walk_repair launch a shard that has stale walks;
    one host read a repair; queries within 1e-12."""
    from repro_torch.device import host_sync_count
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.ppr import (build_sharded_walk_index, ppr_estimate,
                                 repair_walk_index, shard_stale_counts,
                                 shard_walk_index)
    from repro_torch.ppr.shard import repair_walk_index_sharded
    edges, n = rmat_edges(10, 8, seed=3)
    dele, ins = random_batch_update(edges, n, 64, seed=4)
    g = from_coo(edges[:, 0], edges[:, 1], n, edge_capacity=len(edges) + 256,
                 device=cuda)
    cfg = IndexConfig(num_walks=16, max_len=12, seed=2)
    mesh = make_test_mesh(4, device=cuda, model=4)
    sharded = build_sharded_walk_index(g, cfg, mesh=mesh)
    plain = build_walk_index(g, cfg)
    assert torch.equal(sharded.stacked(), shard_walk_index(plain, 4).stacked())
    upd = make_batch_update(dele, ins, 64, 64, device=cuda)
    g2 = apply_batch(g, upd)
    touched = touched_vertices_mask(upd, n)
    stale_shards = int((shard_stale_counts(sharded, touched) > 0).sum())
    before, syncs = wr.LAUNCH_COUNTS["walk_repair"], host_sync_count()
    got, k = repair_walk_index_sharded(sharded, g2, touched)
    assert host_sync_count() - syncs == 1
    assert wr.LAUNCH_COUNTS["walk_repair"] - before == stale_shards > 0
    want, k1 = repair_walk_index(plain, g2, touched)
    assert k == k1 > 0
    assert torch.equal(got.stacked(), shard_walk_index(want, 4).stacked())
    for seeds in ([3], [7, 100]):
        torch.testing.assert_close(ppr_estimate(got, seeds),
                                   ppr_estimate(want, seeds), rtol=0,
                                   atol=1e-12)


# ---------------------------------------------------------------------------
# the LM family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_train_step_bitwise_on_card(cuda, arch, dtype):
    """A microbatch's loss and gradients, then two AdamW steps (2
    microbatches) of an LM smoke config, twice from the same state: all
    bitwise; in f32 the loss within rtol 1e-5 and the gradients within
    rtol 1e-4 / atol 1e-5·max of the CPU's."""
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.models import transformer as T
    from repro_torch.models.tree import tree_leaves, tree_map
    from repro_torch.optim.adamw import init_adamw
    from repro_torch.train import inputs as TI
    from repro_torch.train import steps as TS
    spec = REGISTRY[arch]
    cfg = dataclasses.replace(spec.smoke_config, dtype=dtype)
    results = {}
    for dev, tag in ((cuda, "a"), (cuda, "b"), ("cpu", "cpu")):
        batch = TI.build_inputs(spec, spec.shapes["train_4k"],
                                concrete=True, smoke=True, seed=1,
                                device=dev)
        params = T.init_lm(cfg, torch.Generator(device="cpu").manual_seed(0))
        params = T.trainable(tree_map(lambda p: p.detach().to(dev), params))
        loss, grads = TS.value_and_grad(
            lambda p, b: T.lm_loss(cfg, p, b["tokens"], b["labels"]),
            params, batch)
        step = TS.make_lm_train_step(cfg, n_microbatches=2)
        opt = init_adamw(params)
        losses = []
        for _ in range(2):
            params, opt, l2 = step(params, opt, batch)
            losses.append(l2)
        results[tag] = ([loss] + grads, losses
                        + [p.detach() for p in tree_leaves(params)])
    for i, (a, b) in enumerate(zip(sum(results["a"], []),
                                   sum(results["b"], []))):
        assert torch.equal(a, b), i
    if dtype == "float32":
        for a, c in zip(results["a"][0], results["cpu"][0]):
            if c.numel():
                torch.testing.assert_close(
                    a.cpu().double(), c.double(), rtol=1e-4,
                    atol=1e-5 * float(c.abs().max()) + 1e-30)
        torch.testing.assert_close(results["a"][1][1].cpu(),
                                   results["cpu"][1][1], rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,chunk,window", [(64, 16, None), (97, 32, 20),
                                            (256, 64, 100)])
def test_chunked_attention_matches_naive_on_card(cuda, dtype, s, chunk,
                                                 window):
    from repro_torch.models import layers as L
    g = torch.Generator(device="cpu").manual_seed(s)
    q = torch.randn(2, s, 4, 32, generator=g)
    k, v = torch.randn(2, s, 2, 32, generator=g), \
        torch.randn(2, s, 2, 32, generator=g)
    out = L.chunked_causal_attention(*(t.to(cuda, dtype) for t in (q, k, v)),
                                     window=window, chunk=chunk)
    assert out.dtype == dtype
    qf, kf, vf = (t.to(dtype).double() for t in (q, L._expand_kv(k, 4),
                                                  L._expand_kv(v, 4)))
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) / 32 ** 0.5
    pos = torch.arange(s)
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    p = torch.softmax(torch.where(mask, logits, -1e30), -1)
    ref = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == torch.float32 else \
        dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(out.cpu().double(), ref, **tol)


def test_seg_sum_bf16_rows_on_card(cuda):
    """bf16 rows summed in f32 through pull_rows, then rounded: bitwise
    the plain version on the CPU; the backward (a gather) exact."""
    from repro_torch.models import message
    g = torch.Generator(device="cpu").manual_seed(5)
    idx = torch.randint(0, 97, (4000,), generator=g, dtype=torch.int32)
    vals = torch.randn(4000, 48, generator=g).to(torch.bfloat16)
    before = pc.LAUNCH_COUNTS["pull_rows"]
    got = message.seg_sum(vals.to(cuda), idx.to(cuda), 97)
    assert pc.LAUNCH_COUNTS["pull_rows"] == before + 1
    want = message.seg_sum(vals, idx, 97)
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got.cpu(), want)
    exact = torch.zeros(97, 48, dtype=torch.float64).index_add_(
        0, idx.long(), vals.double())
    torch.testing.assert_close(got.cpu().double(), exact, rtol=1e-2,
                               atol=1e-2)


# ---------------------------------------------------------------------------
# the recsys family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,path", [(10, 2), (1, 1)])
def test_pull_rows_table_gradient_widths_on_card(cuda, d, path):
    """pull_rows at DeepFM's table widths (embed_dim 10: the float2 path;
    table_w's 1: the scalar path), over a slot order of ids into a table
    with many rows and no slot: bitwise the plain version on the CPU, run
    to run, and within atol 1e-5·max of the plain version on the card."""
    from repro_torch.kernels.pull_contrib.ref import pull_rows_ref
    from repro_torch.models.message import slot_order
    rng = np.random.default_rng(d)
    n, e = 200_000, 60_000
    ids = torch.from_numpy(np.concatenate([
        rng.integers(0, n, e - 2_000), np.full(2_000, 17)]).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((e, d)).astype(np.float32))
    order, _ = slot_order(ids.to(cuda), n)
    gc = g.to(cuda)
    assert pc.row_path(d, gc.data_ptr())[0] == path
    before = pc.LAUNCH_COUNTS["pull_rows"]
    out = pc.pull_rows(order, gc, hot_bytes=0)
    torch.cuda.synchronize()
    assert pc.LAUNCH_COUNTS["pull_rows"] == before + 1
    assert pc.ROW_WIDTH_LAUNCHES[d] >= 1
    cpu_order, _ = slot_order(ids, n)
    assert torch.equal(out.cpu(), pull_rows_ref(cpu_order, g))
    assert torch.equal(pc.pull_rows(order, gc, hot_bytes=0), out)
    plain = pull_rows_ref(order, gc)
    scale = float(plain.abs().max())
    assert float((out - plain).abs().max()) <= 1e-5 * scale


def _sparse_order(dev, n=200_000, e=50_000, live=True):
    """A slot order of ``e`` seeded ids into ``n`` rows, most rows empty:
    a hot id of 300 slots (split at K = 64), 2,000 ids out of range (dead
    slots, sorted last); with ``live=False`` every id out of range."""
    from repro_torch.models.message import slot_order
    rng = np.random.default_rng(e)
    ids = rng.integers(0, n, e)
    ids[:300] = 17
    ids[300:2_300] = n + 5
    if not live:
        ids[:] = n
    ids = torch.from_numpy(ids.astype(np.int32))
    return slot_order(ids.to(dev), n)[0], slot_order(ids, n)[0]


@pytest.mark.parametrize("k", [1, 64])
@pytest.mark.parametrize("d", [1, 2, 3, 10, 16, 64, 602])
def test_pull_rows_sparse_destinations_bitwise(cuda, d, k):
    """pull_rows over a slot order whose rows are mostly empty (the live
    plan, the fill, the packed paths at d <= 64, a warp a chunk at 602):
    bitwise the plain version on the CPU, and run to run."""
    from repro_torch.kernels.pull_contrib.ref import pull_rows_ref
    order, cpu_order = _sparse_order(cuda)
    e = order.src.shape[0]
    g = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (e, d)).astype(np.float32))
    gc = g.to(cuda)
    vec, _ = pc.row_path(d, gc.data_ptr())
    assert pc.row_lanes(d, vec) == (32 if d == 602 else
                                    {1: 1, 2: 1, 3: 4, 10: 8, 16: 4,
                                     64: 16}[d])
    before = pc.LAUNCH_COUNTS["pull_rows"]
    out = pc.pull_rows(order, gc, chunk_slots=k, hot_bytes=0)
    torch.cuda.synchronize()
    assert pc.LAUNCH_COUNTS["pull_rows"] == before + 1
    assert torch.equal(out.cpu(), pull_rows_ref(cpu_order, g, chunk_slots=k))
    for _ in range(2):
        assert torch.equal(pc.pull_rows(order, gc, chunk_slots=k,
                                        hot_bytes=0), out)
    empty = order.ptr[1:] == order.ptr[:-1]
    assert int(empty.sum()) > order.ptr.shape[0] // 2
    assert float(out[empty].abs().max()) == 0.0
    info = pc.kernel_info()["packed_paths"]
    assert set(info) == {f"{v}/{g}" for v in pc.ROW_PATHS
                         for g in pc.PACKED_LANES}
    assert all(r > 0 and b >= 1 for r, b in info.values())


@pytest.mark.parametrize("d", [1, 10, 602])
def test_pull_rows_no_live_slot_is_zero(cuda, d):
    """An order with no live slot: no chunk, only the fill: +0.0 rows."""
    order, _ = _sparse_order(cuda, live=False)
    assert int(order.ptr[-1]) == 0
    g = torch.randn(order.src.shape[0], d, device=cuda)
    out = pc.pull_rows(order, g, hot_bytes=0)
    assert out.shape == (order.ptr.shape[0] - 1, d)
    assert torch.equal(out, torch.zeros_like(out))
    assert not bool(torch.signbit(out).any())


@pytest.mark.parametrize("d,kind", [(1, "rmat"), (3, "hub"), (10, "rmat"),
                                    (16, "hub"), (64, "rmat")])
def test_pull_rows_packed_paths_hot_budgets_bitwise(cuda, d, kind):
    """The packed paths with a hot set (tagged slots, L2 policies) over a
    graph's order by dst: every budget bitwise budget 0 and the CPU's."""
    from repro_torch.kernels.pull_contrib.ref import pull_rows_ref
    order, x, xc = _rows_case(cuda, d, kind)
    assert pc.row_lanes(d, pc.row_path(d, x.data_ptr())[0]) < 32
    cpu = pull_rows_ref(PullOrder(*(t.cpu() for t in order)), xc)
    for budget in (0, 4 * d * 1000, 4 * d * x.shape[0]):
        out = pc.pull_rows(order, x, hot_bytes=budget)
        assert torch.equal(pc.pull_rows(order, x, hot_bytes=budget), out)
        assert torch.equal(out.cpu(), cpu)


@pytest.mark.parametrize("d", [1, 10])
def test_pull_rows_meta_scratch_equals_card(cuda, d):
    """The dry-run's branch (``meta``) allocates what the card's does: the
    same tensors in the same order, and the same peak of live bytes (to the card
    allocator's 512-byte rounding)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.launch.dryrun import Counter

    class Allocs(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.made = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor) and not func.is_view:
                self.made.append((tuple(out.shape), out.dtype))
            return out

    made, peaks = {}, {}
    for dev in ("meta", cuda):
        order, _ = _sparse_order(torch.device(dev))
        g = torch.randn(order.src.shape[0], d).to(dev)
        if dev == "meta":
            # the inputs tracked from the start (a view of one, such as
            # the keys' live prefix, is no new storage), then left out
            inputs = [*order, g]
            counter = Counter(memory=True, tracked=inputs)
            with counter, Allocs() as allocs:
                pc.pull_rows(order, g, hot_bytes=0)
            peaks[dev] = counter.peak - sum(
                t.untyped_storage().nbytes() for t in inputs)
        else:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with Allocs() as allocs:
                pc.pull_rows(order, g, hot_bytes=0)
            torch.cuda.synchronize()
            peaks[dev] = torch.cuda.max_memory_allocated() - base
        made[dev] = allocs.made
    assert made["meta"] == made[cuda]
    assert abs(peaks[cuda] - peaks["meta"]) <= 512 * len(made["meta"])


def test_deepfm_train_step_bitwise_on_card(cuda):
    """DeepFM's loss and gradients, then three train steps, at the full
    config's widths on a cut vocabulary, twice from the same state: all
    bitwise; the loss within rtol 1e-5 and the gradients within rtol 1e-4
    / atol 1e-5·max of the CPU's; two pull_rows launches a step (the
    table's and table_w's gradients), none in serve or retrieval."""
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.models import recsys as R
    from repro_torch.models.tree import tree_leaves, tree_map
    from repro_torch.optim.adamw import init_adamw
    from repro_torch.train import steps as TS
    spec = REGISTRY["deepfm"]
    cfg = dataclasses.replace(spec.config, vocab_per_field=2_000)
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(rng.integers(0, 2_000, (512, 39)).astype(
        np.int32))
    labels = torch.from_numpy((rng.random(512) < 0.5).astype(np.float32))
    base = R.init_deepfm(cfg, torch.Generator().manual_seed(0))
    results = {}
    for dev, tag in ((cuda, "a"), (cuda, "b"), ("cpu", "cpu")):
        params = R.trainable(tree_map(lambda p: p.detach().to(dev), base))
        batch = dict(sparse_ids=ids.to(dev), labels=labels.to(dev))
        loss, grads = TS.value_and_grad(
            lambda p, b: R.deepfm_loss(cfg, p, b["sparse_ids"],
                                       b["labels"]), params, batch)
        step = TS.make_recsys_train_step(cfg)
        opt = init_adamw(params)
        losses = []
        launches = pc.LAUNCH_COUNTS["pull_rows"]
        for _ in range(3):
            params, opt, l3 = step(params, opt, batch)
            losses.append(l3)
        if dev != "cpu":
            assert pc.LAUNCH_COUNTS["pull_rows"] - launches == 6
            launches = pc.LAUNCH_COUNTS["pull_rows"]
            probs = TS.make_recsys_serve(cfg)(params, batch)
            assert bool(((probs >= 0) & (probs <= 1)).all())
            TS.make_recsys_retrieval(cfg)(params, dict(
                query_ids=ids[:1].to(dev), cand_ids=ids[:, 0].to(dev)))
            assert pc.LAUNCH_COUNTS["pull_rows"] == launches
        results[tag] = ([loss] + grads, losses
                        + [p.detach() for p in tree_leaves(params)])
    for a, b in zip(sum(results["a"], []), sum(results["b"], [])):
        assert torch.equal(a, b)
    for a, c in zip(results["a"][0], results["cpu"][0]):
        torch.testing.assert_close(a.cpu().double(), c.double(), rtol=1e-4,
                                   atol=1e-5 * float(c.abs().max()) + 1e-30)
    torch.testing.assert_close(results["a"][0][0].cpu(),
                               results["cpu"][0][0], rtol=1e-5, atol=0)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen3-moe-30b-a3b"])
def test_counting_mode_matches_production_on_card(cuda, arch):
    """The LM's counting mode (layers unchecked, attention in one chunk,
    the full-logit loss) against its production mode on the card at the
    smoke config (f32, a train cell of 2 x 64): loss rtol 1e-5, gradients
    rtol 1e-4 / atol 1e-5·max, prefill and two decode steps' logits rtol
    1e-4 / atol 1e-5·max; the embedding's backward a pull_rows launch."""
    from repro_torch.configs.registry import REGISTRY
    from repro_torch.models import transformer as T
    from repro_torch.train import inputs as TI
    from repro_torch.train import steps as TS
    spec = REGISTRY[arch]
    cfg = spec.smoke_config
    counted = dataclasses.replace(cfg, counting=True)
    batch = TI.build_inputs(spec, spec.shapes["train_4k"], concrete=True,
                            smoke=True, seed=1, device=cuda)
    params = T.init_lm(cfg, torch.Generator(device=cuda).manual_seed(0))
    got = {}
    for c in (cfg, counted):
        before = pc.LAUNCH_COUNTS["pull_rows"]
        got[c] = TS.value_and_grad(
            lambda p, b, c=c: T.lm_loss(c, p, b["tokens"], b["labels"]),
            params, batch)
        assert pc.LAUNCH_COUNTS["pull_rows"] > before
    (lp, gp), (lc, gc) = got[cfg], got[counted]
    torch.testing.assert_close(lc, lp, rtol=1e-5, atol=0)
    for a, b in zip(gc, gp):
        if b.numel():
            torch.testing.assert_close(
                a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()) + 1e-30)

    def close(a, b):
        torch.testing.assert_close(
            a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()) + 1e-30)
    toks = batch["tokens"]
    close(TS.make_lm_prefill(counted)(params, toks),
          TS.make_lm_prefill(cfg)(params, toks))
    caches = {c: T.init_cache(c, 2, 8, device=cuda) for c in (cfg, counted)}
    for t in range(2):
        out = {}
        for c in (cfg, counted):
            out[c], caches[c] = TS.make_lm_decode_step(c)(
                params, caches[c], toks[:, t:t + 1])
        close(out[counted], out[cfg])


def test_kernel_meta_branches_match_launches_on_card(cuda):
    """Each kernel wrapper on ``meta`` tensors returns the shapes and
    dtypes its launch on the card returns, records its work, and counts
    no launch."""
    from repro_torch.graph.structure import CSRView, EdgeListGraph
    from repro_torch.kernels import work
    from repro_torch.kernels.slot_count import slot_count as sc
    rng = np.random.default_rng(0)
    n, e = 300, 4000

    def t(a, dev):
        return torch.from_numpy(a).to(dev)
    src_np = rng.integers(0, n, e).astype(np.int32)
    dst_np = rng.integers(0, n, e).astype(np.int32)
    ok_np = rng.random(e) < 0.8
    x_np = rng.standard_normal((n, 6)).astype(np.float32)
    r_np = rng.random(n)
    rsc_np = rng.random(n).astype(np.float32)
    rows_np = rng.integers(0, n, (7, 5)).astype(np.int32)
    host = spmv.pack_blocks(src_np, dst_np, ok_np, n, be=8, vb=16,
                            device="cpu")
    out = {}
    counts = {}
    work.reset()
    for dev in (cuda, torch.device("meta")):
        launches = {k: dict(m.LAUNCH_COUNTS)
                    for k, m in (("pc", pc), ("sc", sc), ("spmv", spmv),
                                 ("sm", sm), ("wr", wr))}
        src, dst, ok = t(src_np, dev), t(dst_np, dev), t(ok_np, dev)
        x, ranks, rsc = t(x_np, dev), t(r_np, dev), t(rsc_np, dev)
        order = pc.pull_order(src, dst, ok, n)
        packed = type(host)(**{
            k: (getattr(host, k).to(dev)
                if isinstance(getattr(host, k), torch.Tensor)
                else getattr(host, k))
            for k in host.__dataclass_fields__})
        awin = torch.ones(packed.num_windows, dtype=torch.bool, device=dev)
        csr = CSRView(*(c.to(dev) for c in EdgeListGraph(
            t(src_np, "cpu"), t(dst_np, "cpu"), t(ok_np, "cpu"),
            n).to_device_csr()))
        out[dev.type] = dict(
            pull_contrib=pc.pull_contrib(order, ranks, ranks),
            pull_rows=pc.pull_rows(order, x),
            slot_count=sc.slot_count(src, ok, n),
            segment_bounds=order.ptr,
            segment_or=sc.segment_or(order.ptr, order.src, order.dst,
                                     ok[:n]),
            frontier_spmv=spmv.frontier_spmv_padded(packed, rsc, awin),
            gated_spmm=sm.gated_spmm(packed, x, awin),
            walk_repair=wr.resample_rows(
                csr, t(rows_np, dev), torch.zeros(7, dtype=torch.int32,
                                                  device=dev),
                (1, 2), torch.arange(7, device=dev), alpha=0.85))
        torch.cuda.synchronize()
        counts[dev.type] = {k: {name: m.LAUNCH_COUNTS[name] - v.get(name, 0)
                                for name in m.LAUNCH_COUNTS}
                            for (k, v), m in zip(launches.items(),
                                                 (pc, sc, spmv, sm, wr))}
    for name, card in out["cuda"].items():
        met = out["meta"][name]
        assert met.device.type == "meta", name
        assert tuple(met.shape) == tuple(card.shape), name
        assert met.dtype == card.dtype, name
        assert work.WORK[name] >= 1, name
    assert sum(v for c in counts["cuda"].values() for v in c.values()) >= 8
    assert all(v == 0 for c in counts["meta"].values() for v in c.values())
