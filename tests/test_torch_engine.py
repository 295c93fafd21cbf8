"""Port parity: the f64 loop behind the five approaches and the kernel
engine's precision ladder, against ``repro``.

  * ``_pagerank_loop`` per method: ranks L∞ ≤ 1e-12 (f64 sums taken in
    another order), ``iterations`` and ``affected_ever`` equal;
  * ``hybrid_pagerank`` / ``update_pagerank(engine="kernel")`` against the
    reference's ladder with ``use_kernel=False``: L∞ ≤ 1e-6, the contract
    of ``tests/test_kernel_serving.py``;
  * the port's fused step equals its unfused step bitwise (on the CPU,
    where the plain SpMV is deterministic), as ``tests/test_fused_step.py``
    holds the reference.
"""
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.core import api as japi
from repro.core import kernel_engine as jke
from repro.core import pagerank as jpr
from repro.graph import dynamic as jdyn
from repro.graph import generators as jgen
from repro.graph import structure as jstr
from repro.kernels.pagerank_spmv import update as jupd

from repro_torch.core import api as tapi
from repro_torch.core import kernel_engine as tke
from repro_torch.core import pagerank as tpr
from repro_torch.core.reference import l1_error, static_pagerank_ref
from repro_torch.graph import dynamic as tdyn
from repro_torch.kernels.pagerank_spmv import update as tupd
from test_torch_common import CPU, assert_bitwise, assert_packed_equal, \
    np_, port_graph, port_packed, port_update


def _linf(a, b):
    return float(np.max(np.abs(np_(a) - np_(b))))


def _case(seed, regime="mixed", scale=7):
    """(jax g0, jax g1, jax update, port g0, port g1, port update, r0)."""
    edges, n, batches = jgen.update_stream(scale, 6, regime=regime,
                                           num_batches=1, batch_size=30,
                                           seed=seed)
    jg = jstr.from_coo(edges[:, 0], edges[:, 1], n,
                       edge_capacity=len(edges) + 64)
    ju = jdyn.make_batch_update(*batches[0], 32, 32)
    jg2 = jdyn.apply_batch(jg, ju)
    r0 = np.array(jpr.static_pagerank(jg).ranks)
    tg, tu = port_graph(jg), port_update(ju)
    return jg, jg2, ju, tg, tdyn.apply_batch(tg, tu), tu, r0


@pytest.mark.parametrize("method", japi.METHODS)
def test_pagerank_loop_matches_reference(method):
    jg, jg2, ju, tg, tg2, tu, r0 = _case(2)
    ref = japi.update_pagerank(jg, jg2, ju, r0, method)
    out = tapi.update_pagerank(tg, tg2, tu, torch.from_numpy(r0), method)
    assert _linf(out.ranks, ref.ranks) <= 1e-12
    assert out.iterations == int(ref.iterations)
    assert_bitwise(out.affected_ever, ref.affected_ever, method)
    assert int(out.edges_processed) == int(ref.edges_processed)
    assert int(out.vertices_processed) == int(ref.vertices_processed)
    assert out.ranks.dtype == torch.float64
    assert out.host_syncs == out.iterations


def test_static_pagerank_matches_oracle():
    edges, n = jgen.rmat_edges(7, 8, seed=4)
    tg = port_graph(jstr.from_coo(edges[:, 0], edges[:, 1], n))
    ref, _ = static_pagerank_ref(edges[:, 0], edges[:, 1], n, tol=1e-14)
    assert l1_error(tpr.static_pagerank(tg).ranks.numpy(), ref) < 1e-8


@pytest.mark.parametrize("method", ["frontier", "frontier_prune"])
def test_kernel_engine_matches_reference(method):
    jg, jg2, ju, tg, tg2, tu, r0 = _case(5)
    ref = japi.update_pagerank(jg, jg2, ju, r0, method, engine="kernel",
                               use_kernel=False)
    out = tapi.update_pagerank(tg, tg2, tu, torch.from_numpy(r0), method,
                               engine="kernel")
    assert _linf(out.ranks, ref.ranks) <= 1e-6
    assert out.ranks.dtype == torch.float64
    assert int(out.edges_processed) > 0 and int(out.vertices_processed) > 0
    # and the port's ladder reaches the port's own f64 fixed point
    xla = tapi.update_pagerank(tg, tg2, tu, torch.from_numpy(r0), method)
    assert _linf(out.ranks, xla.ranks) <= 1e-6


@pytest.mark.parametrize("polish", [True, False])
def test_hybrid_pagerank_matches_reference(polish):
    jg, jg2, ju, tg, tg2, tu, r0 = _case(8, regime="delete_heavy")
    jp = jupd.pack_graph(jg2, be=64, vb=32, spill_lanes_per_window=8)
    aff = jpr.initial_affected(jg, jg2, jdyn.touched_vertices_mask(
        ju, jg.num_vertices))
    flags = dict(closed_form=True, prune=True, expand=True, polish=polish)
    ref = jke.hybrid_pagerank(jg2, jp, r0, aff, use_kernel=False, **flags)
    out = tke.hybrid_pagerank(tg2, port_packed(jp), torch.from_numpy(r0),
                              torch.from_numpy(np.array(aff)), **flags)
    # without the polish both are f32 fixed points (tol_f32 = 1e-7), as
    # tests/test_kernel_serving.py bounds them: 1e-5
    assert _linf(out.ranks, ref.ranks) <= (1e-6 if polish else 1e-5)
    assert out.ranks.dtype == torch.float64


def test_kernel_loop_work_counters_window_granular():
    edges, n = jgen.rmat_edges(8, 8, seed=9)
    tg = port_graph(jstr.from_coo(edges[:, 0], edges[:, 1], n,
                                  edge_capacity=len(edges) + 16))
    packed = tupd.pack_graph(tg, be=128, vb=64)
    E = int(tg.num_valid_edges())
    r0 = torch.full((n,), 1.0 / n, dtype=torch.float32)
    full = tke.kernel_pagerank_loop(tg, packed, r0,
                                    torch.ones(n, dtype=torch.bool),
                                    expand=False)
    assert int(full.edges_processed) == E * full.iterations
    assert int(full.vertices_processed) == \
        packed.num_windows * packed.vb * full.iterations
    assert full.host_syncs == full.iterations
    warm = tpr.static_pagerank(tg).ranks
    aff = torch.zeros(n, dtype=torch.bool)
    aff[0] = True
    gated = tke.kernel_pagerank_loop(tg, packed, warm, aff)
    assert int(gated.edges_processed) < E * max(1, gated.iterations)


def test_df_pagerank_kernel_reaches_oracle():
    edges, n = jgen.rmat_edges(8, 8, seed=21)
    jg = jstr.from_coo(edges[:, 0], edges[:, 1], n,
                       edge_capacity=len(edges) * 2)
    dele, ins = jgen.random_batch_update(edges, n, 12, seed=22)
    tg = port_graph(jg)
    tu = tdyn.make_batch_update(dele, ins, 32, 32, device=CPU)
    tg2 = tdyn.apply_batch(tg, tu)
    packed = tupd.pack_graph(tg2, be=256, vb=128)
    res = tke.df_pagerank_kernel(
        tg, tg2, packed, tdyn.touched_vertices_mask(tu, n),
        tpr.static_pagerank(tg).ranks, tol=1e-7, frontier_tol=1e-5)
    valid = tg2.valid.numpy()
    ref, _ = static_pagerank_ref(tg2.src.numpy()[valid],
                                 tg2.dst.numpy()[valid], n, tol=1e-14)
    assert l1_error(res.ranks.numpy(), ref) < 5e-5     # f32 path


# ---------------------------------------------------------------------------
# fused step == unfused step, bitwise, within the port
# ---------------------------------------------------------------------------

_FLAGS = dict(closed_form=True, prune=True, expand=True)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("polish", [True, False])
def test_fused_bitwise_matches_unfused(seed, polish):
    edges, n, batches = jgen.update_stream(6, 4, regime="mixed",
                                           num_batches=5, batch_size=12,
                                           seed=seed)
    g = port_graph(jstr.from_coo(edges[:, 0], edges[:, 1], n,
                                 edge_capacity=len(edges) + 128))
    packed1 = packed2 = tupd.pack_graph(g, be=32, vb=16,
                                        spill_lanes_per_window=32)
    r1 = r2 = tpr.static_pagerank(g).ranks
    for i, (dels, ins) in enumerate(batches):
        upd = tdyn.make_batch_update(dels, ins, 16, 16, device=CPU)
        g_new = tdyn.apply_batch(g, upd)
        aff = tpr.initial_affected(g, g_new,
                                   tdyn.touched_vertices_mask(upd, n))
        packed2 = tupd.apply_batch_packed(packed2, upd)
        res2 = tke.hybrid_pagerank(g_new, packed2, r2, aff, polish=polish,
                                   **_FLAGS)
        packed1, res1 = tke.fused_hybrid_pagerank(g_new, packed1, upd, r1,
                                                  aff, polish=polish,
                                                  **_FLAGS)
        assert_packed_equal(packed1, packed2, f"batch {i}")
        assert_bitwise(res1.ranks, res2.ranks, f"ranks {i}")
        assert res1.iterations == res2.iterations
        assert int(res1.edges_processed) == int(res2.edges_processed)
        assert int(res1.vertices_processed) == int(res2.vertices_processed)
        assert_bitwise(res1.affected_ever, res2.affected_ever)
        # the fused step reads the overflow count once more
        assert res1.host_syncs == res2.host_syncs + 1
        g, r1, r2 = g_new, res1.ranks, res2.ranks


def test_fused_rerun_after_repack_is_idempotent():
    # overflow recovery re-invokes the SAME fused call on the repacked
    # structure: the update is already applied, so maintenance is a no-op
    # (random deletions and insertions, as the reference's test draws them)
    rng = np.random.default_rng(7)
    n = 48
    init = np.unique(rng.integers(0, n, size=(130, 2)), axis=0)
    init = init[init[:, 0] != init[:, 1]]
    g = port_graph(jstr.from_coo(init[:, 0], init[:, 1], n,
                                 edge_capacity=len(init) + 256))
    packed = tupd.pack_graph(g, be=32, vb=16, spill_lanes_per_window=64)
    ranks = tpr.static_pagerank(g).ranks
    dels = rng.integers(0, n, size=(3, 2))
    ins = rng.integers(0, n, size=(6, 2))
    upd = tdyn.make_batch_update(dels[dels[:, 0] != dels[:, 1]],
                                 ins[ins[:, 0] != ins[:, 1]], 8, 16,
                                 device=CPU)
    g_new = tdyn.apply_batch(g, upd)
    aff = tpr.initial_affected(g, g_new, tdyn.touched_vertices_mask(upd, n))
    p1, res1 = tke.fused_hybrid_pagerank(g_new, packed, upd, ranks, aff,
                                         **_FLAGS)
    p2, res2 = tke.fused_hybrid_pagerank(g_new, p1, upd, ranks, aff,
                                         **_FLAGS)
    assert_packed_equal(p1, p2)
    assert_bitwise(res1.ranks, res2.ranks)


def test_step_stream_and_mesh_rejection():
    jg, jg2, ju, tg, tg2, tu, r0 = _case(1)
    g_new, res = tapi.step_stream(tg, tu, torch.from_numpy(r0))
    assert_bitwise(g_new.valid, jg2.valid)
    ref = japi.update_pagerank(jg, jg2, ju, r0, "frontier_prune")
    assert _linf(res.ranks, ref.ranks) <= 1e-12
    # mesh= is ported (tests/test_torch_dist.py); a mesh must be the
    # port's Mesh with a 'model' axis
    with pytest.raises(TypeError, match="mesh"):
        tapi.update_pagerank(tg, tg2, tu, torch.from_numpy(r0), mesh=object())
    with pytest.raises(ValueError, match="unknown engine"):
        tapi.update_pagerank(tg, tg2, tu, torch.from_numpy(r0),
                             engine="pallas")
