"""Port parity: the packed structure, its device-side maintenance and the
frontier-gated SpMV's plain version, against ``repro``.

  * ``pack_blocks`` leaves and, after every batch of a seeded stream,
    ``apply_batch_packed`` leaves: bitwise; the spill error: same message;
  * the port's plain ``frontier_spmv_padded`` against the reference's
    Pallas kernel run in interpret mode: f32 rtol 1e-4 / atol 1e-6, bf16
    2e-2, the empty graph exactly 0 (the tolerances of
    ``tests/test_kernels.py``; the two sum in different orders).

The CUDA kernel itself needs the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it against the plain version there.
"""
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
from repro.kernels.pagerank_spmv.ops import gated_contrib as j_gated

from repro_torch.kernels.pagerank_spmv import pagerank_spmv as tspmv
from repro_torch.kernels.pagerank_spmv import update as tupd
from repro_torch.kernels.pagerank_spmv.ops import gated_contrib as t_gated
from test_torch_common import CPU, assert_packed_equal, port_graph, \
    port_packed, port_update


@pytest.mark.parametrize("be,vb,spill,extra", [
    (128, 128, 0, 0), (32, 16, 32, 0), (64, 32, 8, 5), (512, 256, 256, 3)])
def test_pack_blocks_leaves_bitwise(be, vb, spill, extra):
    edges, n = jgen.rmat_edges(7, 8, seed=be + vb)
    valid = np.random.default_rng(be).random(len(edges)) < 0.9
    kw = dict(be=be, vb=vb, spill_lanes_per_window=spill,
              extra_entries=extra, overlay_capacity=64)
    ref = jspmv.pack_blocks(edges[:, 0], edges[:, 1], valid, n, **kw)
    port = tspmv.pack_blocks(edges[:, 0], edges[:, 1], valid, n, **kw,
                             device=CPU)
    assert_packed_equal(port, ref)


def test_pack_blocks_pinned_capacity_errors_match():
    edges = np.asarray([[0, 1], [2, 1], [3, 1], [4, 1]], np.int32)
    for kw in (dict(num_entries=1), dict(max_entries_per_window=1)):
        with pytest.raises(ValueError) as ref:
            jspmv.pack_blocks(edges[:, 0], edges[:, 1], np.ones(4, bool),
                              8, be=2, vb=8, **kw)
        with pytest.raises(ValueError) as port:
            tspmv.pack_blocks(edges[:, 0], edges[:, 1], np.ones(4, bool),
                              8, be=2, vb=8, **kw, device=CPU)
        assert str(port.value).split(";")[0] == str(ref.value).split(";")[0]


@pytest.mark.parametrize("overlay", [1024, 24])
@pytest.mark.parametrize("regime", jgen.STREAM_REGIMES)
def test_apply_batch_packed_stream_bitwise(regime, overlay):
    edges, n, batches = jgen.update_stream(
        7, 4, regime=regime, num_batches=8, batch_size=24, seed=21)
    jg = jstr.from_coo(edges[:, 0], edges[:, 1], n,
                       edge_capacity=len(edges) + 256)
    jp = jupd.pack_graph(jg, be=32, vb=16, spill_lanes_per_window=16,
                         overlay_capacity=overlay)
    tp = tupd.pack_graph(port_graph(jg), be=32, vb=16,
                         spill_lanes_per_window=16, overlay_capacity=overlay)
    assert_packed_equal(tp, jp, "pack")
    drops = 0
    for step, (dels, ins) in enumerate(batches):
        ju = jdyn.make_batch_update(dels, ins, 32, 32)
        jp2, jd = jupd._apply_batch_packed(jp, ju)
        tp2, td = tupd._apply_batch_packed(tp, port_update(ju))
        assert_packed_equal(tp2, jp2, f"batch {step}")
        assert int(td) == int(jd), step
        assert_packed_equal(tp, jp, f"input untouched {step}")
        drops += int(jd)
        jp, tp = jp2, tp2
    assert jupd.packed_edge_set(jp) == tupd.packed_edge_set(tp)
    if overlay < 100:
        assert drops > 0            # the small overlay did overflow


def test_spill_exhaustion_same_error():
    jg = jstr.from_coo(np.array([0]), np.array([1]), 64, edge_capacity=64)
    ins = np.asarray([[i, 1] for i in range(2, 14)], np.int32)
    ju = jdyn.make_batch_update(np.zeros((0, 2), np.int32), ins, 8, 16)
    jp = jupd.pack_graph(jg, be=8, vb=64, spill_lanes_per_window=0)
    tp = port_packed(jp)
    with pytest.raises(ValueError) as ref:
        jupd.apply_batch_packed(jp, ju)
    with pytest.raises(tupd.PackedSpillError) as port:
        tupd.apply_batch_packed(tp, port_update(ju))
    assert str(port.value) == str(ref.value)
    out = tupd.apply_batch_packed(tp, port_update(ju), check=False)
    assert_packed_equal(out, jupd.apply_batch_packed(jp, ju, check=False))
    assert len(tupd.packed_edge_set(out)) == 8


# ---------------------------------------------------------------------------
# the plain version against the reference kernel (interpret mode)
# ---------------------------------------------------------------------------

def _packed_pair(be, vb, seed=11):
    edges, n = jgen.rmat_edges(7, 8, seed=seed)
    jp = jspmv.pack_blocks(edges[:, 0], edges[:, 1],
                           np.ones(len(edges), bool), n, be=be, vb=vb)
    return jp, port_packed(jp)


@pytest.mark.parametrize("frac", [1.0, 0.25, 0.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frontier_spmv_plain_matches_reference_kernel(dtype, frac):
    jp, tp = _packed_pair(be=128, vb=128)
    rng = np.random.default_rng(3)
    v_pad = jp.num_windows * jp.vb
    rsc = rng.random(v_pad).astype(np.float32)
    awin = rng.random(jp.num_windows) < frac
    ref = jspmv.frontier_spmv_padded(
        jp, jnp.asarray(rsc, getattr(jnp, dtype)), jnp.asarray(awin),
        interpret=True)
    out = tspmv.frontier_spmv_padded(
        tp, torch.from_numpy(rsc).to(getattr(torch, dtype)),
        torch.from_numpy(awin))
    assert out.dtype == torch.float32 and out.shape == (v_pad,)
    tol = dict(rtol=1e-4, atol=1e-6) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **tol)
    inactive = ~np.repeat(awin, jp.vb)
    assert np.all(out.numpy()[inactive] == 0.0)


@pytest.mark.parametrize("be,vb", [(64, 32), (512, 256)])
def test_gated_contrib_matches_reference(be, vb):
    edges, n = jgen.erdos_renyi_edges(500, 4000, seed=be)
    jp = jspmv.pack_blocks(edges[:, 0], edges[:, 1],
                           np.ones(len(edges), bool), n, be=be, vb=vb)
    tp = port_packed(jp)
    rng = np.random.default_rng(be)
    ranks = rng.random(n)
    deg = np.bincount(edges[:, 0], minlength=n) + 1
    inv = 1.0 / deg
    for frac in (1.0, 0.1):
        aff = rng.random(n) < frac
        ref = j_gated(jp, jnp.asarray(ranks), jnp.asarray(inv),
                      jnp.asarray(aff), use_kernel=True)
        out = t_gated(tp, torch.from_numpy(ranks), torch.from_numpy(inv),
                      torch.from_numpy(aff))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-6)


def test_frontier_spmv_empty_graph_is_zero():
    tp = tspmv.pack_blocks(np.zeros(0, np.int32), np.zeros(0, np.int32),
                           np.zeros(0, bool), 128, be=128, vb=128,
                           device=CPU)
    out = t_gated(tp, torch.ones(128, dtype=torch.float64),
                  torch.ones(128, dtype=torch.float64),
                  torch.ones(128, dtype=torch.bool))
    assert float(out.abs().max()) == 0.0


def test_frontier_spmv_rejects_devices_without_a_kernel():
    """A ``meta`` call runs the launch path with no launch (the dry-run's
    device); a packed structure on another device than the ranks is
    refused."""
    _, tp = _packed_pair(be=128, vb=128)
    v_pad = tp.num_windows * tp.vb
    rsc = torch.zeros(v_pad, device="meta")
    awin = torch.ones(tp.num_windows, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="is on cpu, expected meta"):
        tspmv.frontier_spmv_padded(tp, rsc, awin)
    meta = type(tp)(**{k: (getattr(tp, k).to("meta")
                           if isinstance(getattr(tp, k), torch.Tensor)
                           else getattr(tp, k))
                       for k in tp.__dataclass_fields__})
    before = tspmv.LAUNCH_COUNTS["frontier_spmv"]
    out = tspmv.frontier_spmv_padded(meta, rsc, awin)
    assert (out.device.type, tuple(out.shape), out.dtype) == \
        ("meta", (v_pad,), torch.float32)
    assert tspmv.LAUNCH_COUNTS["frontier_spmv"] == before
