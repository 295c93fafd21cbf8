"""The frontier-gated SpMV kernel's order of sums in plain PyTorch, and the
chunk-plan cache, against ``repro``.

  * ``ref.frontier_spmv_split_ref`` (windows cut into chunks of at most K
    entries, chunk 0 summed into the window's rows, chunks 1.. into
    partial rows added in chunk order, as ``csrc/frontier_spmv.cu`` sums
    them) against the reference's Pallas ``frontier_spmv_padded`` in
    interpret mode, for K in {1, 2, 7, the widest window}, f32 and bf16
    ranks, 0 %, partial and 100 % active windows, on a pack whose last
    window owns a capacity tail and on a pack after two batches (overlay
    lanes out of dst order, holes from deletions): rtol 1e-4 / atol 1e-6,
    the kernel tolerance of ``tests/test_kernels.py`` (f32 sums in other
    orders; bf16 ranks are widened to f32 by both before summing);
    inactive windows exactly 0;
  * ``plan.cached_plan``: one plan object for a packed structure, carried
    through ``apply_batch_packed``; a new one after a repack.

The kernel itself needs the card: ``tests/test_torch_cuda.py``.
"""
import functools

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax.numpy as jnp
from repro.graph import dynamic as jdyn
from repro.graph import generators as jgen
from repro.graph import structure as jstr
from repro.kernels.pagerank_spmv import pagerank_spmv as jspmv
from repro.kernels.pagerank_spmv import update as jupd

from repro_torch.kernels.pagerank_spmv import pagerank_spmv as tspmv
from repro_torch.kernels.pagerank_spmv import update as tupd
from repro_torch.kernels.pagerank_spmv.ref import frontier_spmv_ref_padded, \
    frontier_spmv_split_ref
from repro_torch.kernels.segment_ops import plan as tplan
from test_torch_common import np_, port_graph, port_packed, port_update

RTOL, ATOL = 1e-4, 1e-6
FRACS = {"none": 0.0, "partial": 0.4, "all": 1.0}


def _tail_pack():
    """R-MAT scale 9 in entries of 16 lanes, spill lanes and 80 empty tail
    entries, all owned by the last window, which is then the widest (as
    the serve engine's capacity tail makes it)."""
    edges, n = jgen.rmat_edges(9, 8, seed=4)
    jp = jspmv.pack_blocks(edges[:, 0], edges[:, 1],
                           np.ones(len(edges), bool), n, be=16, vb=32,
                           spill_lanes_per_window=8, extra_entries=80)
    return jp


def _batched_pack():
    """R-MAT scale 8 packed with spill lanes, then two batches of inserts
    and deletes through ``apply_batch_packed`` on both packages."""
    edges, n = jgen.rmat_edges(8, 6, seed=9)
    jg = jstr.from_coo(edges[:, 0], edges[:, 1], n,
                       edge_capacity=len(edges) + 128)
    kw = dict(be=32, vb=16, spill_lanes_per_window=16, extra_entries=3)
    jp = jupd.pack_graph(jg, **kw)
    tp = tupd.pack_graph(port_graph(jg), **kw)
    for b in range(2):
        dele, ins = jgen.random_batch_update(edges, n, 24, seed=b + 1)
        ju = jdyn.make_batch_update(dele, ins, 32, 32)
        jp = jupd.apply_batch_packed(jp, ju)
        tp = tupd.apply_batch_packed(tp, port_update(ju))
    return jp, tp


@functools.lru_cache(maxsize=None)
def _case(pack, dtype, frac):
    """(jax pack, port pack, rsc, active windows, reference output)."""
    if pack == "tail":
        jp = _tail_pack()
        tp = port_packed(jp)
    else:
        jp, tp = _batched_pack()
    rng = np.random.default_rng(len(pack) + int(100 * FRACS[frac]))
    v_pad = jp.num_windows * jp.vb
    rsc = rng.random(v_pad).astype(np.float32)
    awin = rng.random(jp.num_windows) < FRACS[frac]
    if frac == "partial":
        awin[[0, -1]] = True           # the hub and the tail window
    ref = np.asarray(jspmv.frontier_spmv_padded(
        jp, jnp.asarray(rsc, getattr(jnp, dtype)), jnp.asarray(awin),
        interpret=True))
    return jp, tp, rsc, awin, ref


def _widest(tp):
    return int(np.diff(np_(tp.entry_start).astype(np.int64)).max())


@pytest.mark.parametrize("frac", sorted(FRACS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2, 7, "widest"])
@pytest.mark.parametrize("pack", ["tail", "batched"])
def test_split_sums_match_reference_kernel(pack, k, dtype, frac):
    jp, tp, rsc, awin, ref = _case(pack, dtype, frac)
    widest = _widest(tp)
    small = k != "widest"
    k = k if small else widest
    assert (k < widest) == small          # a small K really splits
    out = frontier_spmv_split_ref(
        tp, torch.from_numpy(rsc).to(getattr(torch, dtype)),
        torch.from_numpy(awin), k)
    assert out.dtype == torch.float32 and out.shape == rsc.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
    assert np.all(out.numpy()[~np.repeat(awin, tp.vb)] == 0.0)


def test_tail_pack_gives_the_last_window_the_tail():
    jp = _tail_pack()
    owned = np.diff(np.asarray(jp.entry_start, np.int64))
    assert owned[-1] > 80 > owned[:-1].max() > 7
    # the tail's entries hold no live lane
    tail = np.asarray(jp.valid)[-80:]
    assert not tail.any()


def test_batched_pack_has_overlay_lanes_out_of_dst_order():
    _, tp = _batched_pack()
    assert int((tp.ovl_key != tspmv.LANE_SENTINEL).sum()) > 0
    rel = np_(tp.dst_rel).astype(np.int64)
    win = np_(tp.window).astype(np.int64)
    live = np_(tp.valid) > 0
    # per window, live lanes in lane order: some row comes after a larger
    key = (win[:, None] * tp.vb + rel)[live]
    assert np.any(np.diff(key) < 0)
    # holes: a dead lane between two live lanes of one entry
    assert np.any(live[:, :-2] & ~live[:, 1:-1] & live[:, 2:])


@pytest.mark.parametrize("k", [1, 3])
def test_split_sums_match_unsplit_plain_version(k):
    _, tp, rsc, awin, _ = _case("batched", "float32", "partial")
    r, a = torch.from_numpy(rsc), torch.from_numpy(awin)
    plain = frontier_spmv_ref_padded(tp.src, tp.dst_rel, tp.valid,
                                     tp.window, r, a, tp.vb)
    torch.testing.assert_close(frontier_spmv_split_ref(tp, r, a, k), plain,
                               rtol=RTOL, atol=ATOL)


def test_wrapper_on_cpu_ignores_chunk_entries():
    _, tp, rsc, awin, _ = _case("tail", "float32", "partial")
    r, a = torch.from_numpy(rsc), torch.from_numpy(awin)
    before = tspmv.LAUNCH_COUNTS["frontier_spmv"]
    out = tspmv.frontier_spmv_padded(tp, r, a, chunk_entries=2)
    assert tspmv.LAUNCH_COUNTS["frontier_spmv"] == before   # plain version
    assert torch.equal(out, tspmv.frontier_spmv_padded(tp, r, a))


# ---------------------------------------------------------------------------
# the plan cache
# ---------------------------------------------------------------------------

def test_plan_cache_reuses_the_plan_across_batches_and_drops_on_repack():
    edges, n = jgen.rmat_edges(7, 6, seed=2)
    tg = port_graph(jstr.from_coo(edges[:, 0], edges[:, 1], n,
                                  edge_capacity=len(edges) + 64))
    kw = dict(be=32, vb=16, spill_lanes_per_window=16)
    tp = tupd.pack_graph(tg, **kw)
    first = tplan.cached_plan(tp.entry_start, tp.num_entries, 4)
    assert tplan.cached_plan(tp.entry_start, tp.num_entries, 4) is first
    # another K is another plan, cached beside the first
    other = tplan.cached_plan(tp.entry_start, tp.num_entries, 2)
    assert other is not first
    assert tplan.cached_plan(tp.entry_start, tp.num_entries, 2) is other
    # a batch carries entry_start on: the same plan object
    dele, ins = jgen.random_batch_update(edges, n, 16, seed=3)
    upd = port_update(jdyn.make_batch_update(dele, ins, 16, 16))
    tp2 = tupd.apply_batch_packed(tp, upd)
    assert tp2.entry_start is tp.entry_start
    assert tplan.cached_plan(tp2.entry_start, tp2.num_entries, 4) is first
    # a repack makes a new entry_start, hence a new plan, equal in value
    tp3 = tupd.pack_graph(tg, **kw)
    third = tplan.cached_plan(tp3.entry_start, tp3.num_entries, 4)
    assert third is not first
    for a, b in zip(third[:7], first[:7]):
        assert torch.equal(a, b)
    assert third.num_partials == first.num_partials


def test_plan_cache_drops_the_plan_with_its_tensor():
    es = torch.tensor([0, 3, 3, 9], dtype=torch.int32)
    key = id(es)
    tplan.cached_plan(es, 9, 2)
    assert key in tplan._PLANS
    del es
    assert key not in tplan._PLANS
    # a new tensor gets its own plan, whatever address it reuses
    es2 = torch.tensor([0, 1, 2, 9], dtype=torch.int32)
    plan = tplan.cached_plan(es2, 9, 2)
    assert torch.equal(plan.begin[:3], torch.tensor([0, 1, 2],
                                                    dtype=torch.int32))
