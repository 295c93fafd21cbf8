"""The chunk plan of the gated segment-SpMM kernel, and the kernel's order
of sums in plain PyTorch, against ``repro``.

  * ``plan.chunk_plan``: every entry is covered once and in order, an
    empty window gets one chunk of no entry, a window of exactly K entries
    is one chunk and one of K+1 two, the hub window of an R-MAT graph
    splits into ceil(n/K) chunks, and the plan's lengths are the bounds
    its module states;
  * ``ref.gated_spmm_split_ref`` (per-chunk partials summed in chunk
    order, as ``csrc/gated_spmm.cu`` sums them) against the reference's
    ``aggregate_features`` without and with its Pallas kernel (interpret
    mode) for K in {1, 2, 7, large}: rtol 1e-4 / atol 1e-5, the tolerance
    of ``tests/test_kernels.py`` (f32 sums in different orders); inactive
    windows exactly 0.

The kernel itself needs the card: ``tests/test_torch_cuda.py``.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.graph import dynamic as jdyn
from repro.graph import generators as jgen
from repro.graph import structure as jstr
from repro.kernels.pagerank_spmv import pagerank_spmv as jspmv
from repro.kernels.pagerank_spmv import update as jupd
from repro.kernels.segment_ops.ops import aggregate_features as j_agg

from repro_torch.kernels.pagerank_spmv import update as tupd
from repro_torch.kernels.segment_ops import segment_matmul as tsm
from repro_torch.kernels.segment_ops.plan import chunk_plan, plan_sizes
from repro_torch.kernels.segment_ops.ref import gated_spmm_ref, \
    gated_spmm_split_ref
from test_torch_common import np_, port_graph, port_packed, port_update
from test_torch_gnn import ATOL, RTOL, _assert_inactive_zero

BIG_K = 1 << 20     # no window splits


@functools.lru_cache(maxsize=None)
def _split_case(d):
    """As ``test_torch_gnn._spmm_case``, with entries of 16 lanes, so that
    windows own up to ~40 entries and K = 7 splits them."""
    edges, n = jgen.rmat_edges(8, 8, seed=d)
    jp = jspmv.pack_blocks(edges[:, 0], edges[:, 1],
                           np.ones(len(edges), bool), n, be=16, vb=64)
    rng = np.random.default_rng(d)
    feats = rng.standard_normal((n, d)).astype(np.float32)
    aff = rng.random(n) < 0.5
    aff[:64] = True                    # the hub window is active
    ref = {k: np.asarray(j_agg(jp, jnp.asarray(feats), jnp.asarray(aff),
                               use_kernel=k)) for k in (False, True)}
    return jp, feats, aff, ref


def _plan_np(owned, k):
    es = torch.tensor(np.concatenate([[0], np.cumsum(owned)]),
                      dtype=torch.int32)
    plan = chunk_plan(es, int(es[-1]), k)
    nw = len(owned)
    real = np_(plan.window) < nw
    return plan, {f: np_(getattr(plan, f))[real]
                  for f in ("window", "begin", "end", "part")}


def _check_plan(owned, k):
    """The invariants every plan holds; returns the real chunks."""
    owned = np.asarray(owned, np.int64)
    nw, ne = len(owned), int(owned.sum())
    plan, ch = _plan_np(owned, k)
    n_chunks, n_parts, n_splits = plan_sizes(nw, ne, k)
    assert plan.window.shape[0] == n_chunks
    assert plan.split_window.shape[0] == n_splits
    assert plan.num_partials == n_parts
    assert all(t.dtype == torch.int32 for t in plan[:7])
    # the real chunks are a prefix, then only surplus slots
    real = np_(plan.window) < nw
    assert not np.any(real[int(real.sum()):])
    # windows in order, each window's chunks tile its entries in order
    assert np.all(np.diff(ch["window"]) >= 0)
    assert np.array_equal(ch["begin"][1:], ch["end"][:-1])
    assert ch["begin"][0] == 0 and ch["end"][-1] == ne
    size = ch["end"] - ch["begin"]
    assert np.all((0 <= size) & (size <= k))
    per_window = np.bincount(ch["window"], minlength=nw)
    assert np.array_equal(per_window, np.maximum(1, -(-owned // k)))
    assert np.array_equal(np.bincount(ch["window"], weights=size,
                                      minlength=nw), owned)
    # chunk 0 writes out; chunks 1.. own distinct partial slots in order
    first = np.r_[True, ch["window"][1:] != ch["window"][:-1]]
    assert np.all(ch["part"][first] == -1)
    parts = ch["part"][~first]
    assert np.array_equal(parts, np.arange(len(parts)))
    assert len(parts) <= n_parts
    # the split windows: those of more than one chunk, with their slots
    sw = np_(plan.split_window)
    split = np.flatnonzero(per_window > 1)
    assert np.array_equal(sw[:len(split)], split)
    assert np.all(sw[len(split):] == nw)
    for s, w in enumerate(split):
        slots = ch["part"][(ch["window"] == w) & ~first]
        assert plan.split_part[s] == slots[0]
        assert plan.split_count[s] == len(slots)
    return ch


@pytest.mark.parametrize("k", [1, 2, 3, 7, 64])
def test_chunk_plan_covers_entries_in_order(k):
    owned = np.random.default_rng(k).integers(0, 20, size=40)
    owned[[3, 17]] = 0                 # empty windows among the others
    owned[5] = 150                     # a hub
    _check_plan(owned, k)


@pytest.mark.parametrize("k", [4, 64])
def test_chunk_plan_splits_at_k(k):
    # windows of 0, K, K+1 and 2K+1 entries
    ch = _check_plan([0, k, k + 1, 2 * k + 1], k)
    size = ch["end"] - ch["begin"]
    assert np.array_equal(ch["window"], [0, 1, 2, 2, 3, 3, 3])
    assert np.array_equal(size, [0, k, k, 1, k, k, 1])
    assert np.array_equal(ch["part"], [-1, -1, -1, 0, -1, 1, 2])


def test_chunk_plan_empty_window_gets_no_work():
    ch = _check_plan([0, 0, 5, 0], 2)
    empty = ch["window"] != 2
    assert np.array_equal(ch["window"][empty], [0, 1, 3])
    assert np.all(ch["begin"][empty] == ch["end"][empty])
    assert np.all(ch["part"][empty] == -1)


@pytest.mark.parametrize("k", [16, 64])
def test_chunk_plan_rmat_hub_window(k):
    edges, n = jgen.rmat_edges(12, 16, seed=0)
    jp = jspmv.pack_blocks(edges[:, 0], edges[:, 1],
                           np.ones(len(edges), bool), n, be=64, vb=256,
                           spill_lanes_per_window=16, extra_entries=7)
    owned = np.diff(np.asarray(jp.entry_start, np.int64))
    hub = int(np.argmax(owned))
    assert owned[hub] > 2 * k
    ch = _check_plan(owned, k)
    assert int((ch["window"] == hub).sum()) == -(-int(owned[hub]) // k)


def test_chunk_plan_rejects_k_below_one():
    with pytest.raises(ValueError, match="k must be >= 1"):
        chunk_plan(torch.tensor([0, 4], dtype=torch.int32), 4, 0)


def test_scratch_bytes_is_the_partial_bound():
    jp, _, _, _ = _split_case(16)
    tp = port_packed(jp)
    _, parts, _ = plan_sizes(tp.num_windows, tp.num_entries, 2)
    assert tsm.scratch_bytes(tp, 16, 2) == parts * tp.vb * 16 * 4
    assert tsm.scratch_bytes(tp, 16, BIG_K) == 0


@pytest.mark.parametrize("k", [1, 2, 7, BIG_K])
def test_scratch_bytes_used_counts_the_split_chunks(k):
    jp, _, _, _ = _split_case(16)
    tp = port_packed(jp)
    owned = np.diff(np.asarray(jp.entry_start, np.int64))
    tiles = int((np.maximum(-(-owned // k), 1) - 1).sum())
    assert tsm.scratch_bytes_used(tp, 16, k) == tiles * tp.vb * 16 * 4
    assert tsm.scratch_bytes_used(tp, 16, k) <= tsm.scratch_bytes(tp, 16, k)
    assert (tiles > 0) == (k < BIG_K)


# ---------------------------------------------------------------------------
# the kernel's order of sums against the reference
# ---------------------------------------------------------------------------

def _split(tp, feats, aff, k):
    return gated_spmm_split_ref(
        tp.src, tp.dst_rel, tp.valid, tp.window, tp.entry_start,
        torch.from_numpy(feats), tp.active_windows(torch.from_numpy(aff)),
        tp.num_vertices, tp.vb, k)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("k", [1, 2, 7, BIG_K])
@pytest.mark.parametrize("d", [16, 130])
def test_split_sums_match_reference(d, k, use_kernel):
    jp, feats, aff, ref = _split_case(d)
    tp = port_packed(jp)
    owned = np.diff(np_(tp.entry_start).astype(np.int64))
    assert (owned.max() > k) == (k < BIG_K)     # small K really splits
    assert not aff.all() and aff.any()
    out = _split(tp, feats, aff, k)
    assert out.dtype == torch.float32 and out.shape == (jp.num_vertices, d)
    np.testing.assert_allclose(out.numpy(), ref[use_kernel], rtol=RTOL,
                               atol=ATOL)
    _assert_inactive_zero(out, tp, aff)


@pytest.mark.parametrize("k", [1, 7])
def test_split_sums_after_batch_match_reference(k):
    # lanes claimed through the overlay are no longer dst-sorted
    edges, n = jgen.rmat_edges(7, 6, seed=9)
    jg = jstr.from_coo(edges[:, 0], edges[:, 1], n,
                       edge_capacity=len(edges) + 64)
    kw = dict(be=128, vb=32, spill_lanes_per_window=16, extra_entries=3)
    jp = jupd.pack_graph(jg, **kw)
    tp = tupd.pack_graph(port_graph(jg), **kw)
    dele, ins = jgen.random_batch_update(edges, n, 24, seed=k)
    ju = jdyn.make_batch_update(dele, ins, 32, 32)
    jp = jupd.apply_batch_packed(jp, ju)
    tp = tupd.apply_batch_packed(tp, port_update(ju))
    rng = np.random.default_rng(k)
    feats = rng.standard_normal((n, 24)).astype(np.float32)
    aff = rng.random(n) < 0.4
    ref = np.asarray(j_agg(jp, jnp.asarray(feats), jnp.asarray(aff),
                           use_kernel=False))
    out = _split(tp, feats, aff, k)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
    _assert_inactive_zero(out, tp, aff)


def test_split_sums_match_unsplit_plain_version():
    jp, feats, aff, _ = _split_case(16)
    tp = port_packed(jp)
    awin = tp.active_windows(torch.from_numpy(aff))
    plain = gated_spmm_ref(tp.src, tp.dst_rel, tp.valid, tp.window,
                           torch.from_numpy(feats), awin, tp.num_vertices,
                           tp.vb)
    for k in (1, 3, BIG_K):
        torch.testing.assert_close(_split(tp, feats, aff, k), plain,
                                   rtol=RTOL, atol=ATOL)
