"""Port parity: the roofline (``repro_torch.roofline.analysis``) against
``repro.roofline.analysis``.

``model_flops`` equals the reference's for every cell of
``all_cells(include_pagerank=True)``, DeepFM's four included; both SpMV
iteration costs charge the reference's bytes (at the card's rate);
``build_table`` / ``to_markdown`` read records written in the
reference's ``dryrun_<mesh>.json`` schema; and no TPU figure is left.
"""
import dataclasses
import inspect
import json

import pytest

import repro  # noqa: F401
from repro.configs.registry import REGISTRY as JREG
from repro.configs.registry import all_cells as j_all_cells
from repro.roofline import analysis as JA

from repro_torch.configs.registry import REGISTRY as TREG
from repro_torch.configs.registry import all_cells
from repro_torch.roofline import analysis as TA

CELLS = [(s.arch_id, c.name) for s, c in j_all_cells(include_pagerank=True)]


def test_the_port_lists_every_cell_of_the_reference():
    assert [(s.arch_id, c.name) for s, c in
            all_cells(include_pagerank=True)] == CELLS
    assert sum(s.family == "recsys" for s, _ in
               all_cells(include_pagerank=True)) == 4


@pytest.mark.parametrize("arch_id,cell_name", CELLS)
def test_model_flops_equal_the_reference(arch_id, cell_name):
    jspec, tspec = JREG[arch_id], TREG[arch_id]
    want = JA.model_flops(jspec, jspec.shapes[cell_name])
    fam = dict(lm=TA.lm_model_flops, gnn=TA.gnn_model_flops,
               recsys=TA.recsys_model_flops,
               pagerank=TA.pagerank_model_flops)[tspec.family]
    cell = tspec.shapes[cell_name]
    assert TA.model_flops(tspec, cell) == fam(tspec, cell) == want > 0


def test_no_tpu_figure_is_left():
    tpu = {197e12, 819e9, 50e9}          # the reference's v5e constants
    assert (JA.PEAK_FLOPS, JA.HBM_BW, JA.LINK_BW) == (197e12, 819e9, 50e9)
    for name, v in vars(TA).items():
        if isinstance(v, float):
            assert v not in tpu, name
    assert not hasattr(TA, "SPMV_STEP_OVERHEAD_S")
    assert TA.HBM_BW == TA.H100_HBM_BW == 3.35e12
    assert TA.PEAK_FLOPS == TA.H100_PEAK_FLOPS_BF16 == 989e12
    assert TA.H100_PEAK_FLOPS_F32 == 67e12
    assert "H100" in inspect.getsource(TA).split("\n\n")[0] + TA.__doc__
    for fn in ("dense_spmv_iteration_cost", "gated_spmv_iteration_cost"):
        assert list(inspect.signature(getattr(TA, fn)).parameters) == \
            list(inspect.signature(getattr(JA, fn)).parameters)


@pytest.mark.parametrize("edges,vertices", [(32_416_274, 2_097_152),
                                            (1_000, 37)])
def test_dense_cost_charges_the_reference_bytes(edges, vertices):
    want = JA.dense_spmv_iteration_cost(num_edges=edges,
                                        num_vertices=vertices)
    got = TA.dense_spmv_iteration_cost(num_edges=edges,
                                       num_vertices=vertices)
    for k in ("edge_bytes", "vertex_bytes"):
        assert got[k] == want[k]
    assert got["memory_s"] * TA.HBM_BW == pytest.approx(
        want["memory_s"] * JA.HBM_BW, rel=1e-12)
    assert got["total_s"] == got["memory_s"]


@pytest.mark.parametrize("geom", [
    dict(total_entries=94_976, active_entries=4_800.0, active_windows=837.0,
         be=512, vb=256, v_rsc=2_097_152),
    dict(total_entries=94_976, active_entries=94_976.0,
         active_windows=8_192.0, be=512, vb=256, v_rsc=2_097_152),
    dict(total_entries=10, active_entries=0.0, active_windows=0.0,
         be=256, vb=128, v_rsc=1_000)])
def test_gated_cost_memory_term_is_the_reference_bytes(geom):
    """The memory term moves the reference's bytes at the card's rate;
    the compute term is the Hopper kernel's model: the device's floor for
    a call with active windows, nothing without, never the TPU grid's
    per-entry step."""
    from repro_torch.kernels.pagerank_spmv import tune
    want = JA.gated_spmv_iteration_cost(**geom)
    got = TA.gated_spmv_iteration_cost(**geom)
    assert got["memory_s"] * TA.HBM_BW == pytest.approx(
        want["memory_s"] * JA.HBM_BW, rel=1e-12)
    assert got["total_s"] == max(got["compute_s"], got["memory_s"])
    if geom["active_windows"]:
        assert got["compute_s"] >= tune.DEVICE_CALL_S
        assert got["compute_s"] < want["compute_s"]
    else:
        assert got["compute_s"] == 0.0


def test_gated_cost_follows_the_active_share():
    base = dict(total_entries=94_976, be=512, vb=256, v_rsc=2_097_152)
    few = TA.gated_spmv_iteration_cost(active_entries=500.0,
                                       active_windows=100.0, **base)
    all_ = TA.gated_spmv_iteration_cost(active_entries=94_976.0,
                                        active_windows=8_192.0, **base)
    assert few["compute_s"] < all_["compute_s"]
    assert few["memory_s"] < all_["memory_s"]


def test_recsys_bound_terms():
    """The train step's bytes: 7 f32 passes over every parameter (AdamW)
    plus the batch's ids and rows; its bound is the bytes (~3.6 ms), its
    FLOP term ~2.8 ms at f32's 67 TFLOP/s."""
    spec = TREG["deepfm"]
    cell = spec.shapes["train_batch"]
    flops = TA.model_flops(spec, cell)
    nbytes = TA.recsys_model_bytes(spec, cell)
    cfg = spec.config
    assert nbytes == 4.0 * (65_536 * (39 * 12 + 2)
                            + 7 * (cfg.param_count() + 1))
    b = TA.analytic_bound(flops, nbytes)
    assert b["bound_by"] == "bytes"
    assert b["memory_s"] == pytest.approx(3.626e-3, rel=1e-3)
    assert b["compute_s"] == pytest.approx(2.80e-3, rel=1e-2)
    serve = TA.analytic_bound(
        TA.model_flops(spec, spec.shapes["serve_bulk"]),
        TA.recsys_model_bytes(spec, spec.shapes["serve_bulk"]))
    assert serve["bound_by"] == "operations"
    ret = spec.shapes["retrieval_cand"]
    assert TA.recsys_model_bytes(spec, ret) == 4.0 * (39 * 11
                                                      + 1_000_000 * 12)


def _records(tmp_path):
    """One record of each status in the reference's schema, on both
    meshes."""
    ok = dict(arch="deepfm", shape="train_batch", status="OK",
              cost={"flops": 4.0e12, "bytes accessed": 9.0e11},
              cost_counting={"flops": 5.0e12, "bytes accessed": 1.0e12},
              collectives={"total": 2.0e9},
              memory={"peak_per_device_bytes": 3 * 2**30})
    lm = dict(arch="qwen2.5-3b", shape="train_4k", status="OK",
              cost={"flops": 1.0e15, "bytes accessed": 1.0e11},
              collectives={"total": 1.0e9},
              memory={"peak_per_device_bytes": 2**30})
    skip = dict(arch="qwen2.5-3b", shape="long_500k", status="SKIP",
                skip_reason="pure full-attention arch")
    err = dict(arch="pna", shape="molecule", status="ERROR",
               error="x" * 200)
    for mesh in ("single", "multi"):
        with open(tmp_path / f"dryrun_{mesh}.json", "w") as f:
            json.dump([ok, lm, skip, err], f)


def test_build_table_reads_the_reference_schema(tmp_path):
    _records(tmp_path)
    got = TA.build_table(str(tmp_path))
    want = JA.build_table(str(tmp_path))
    assert [(r.arch, r.shape, r.mesh, r.status) for r in got] == \
        [(r.arch, r.shape, r.mesh, r.status) for r in want]
    assert len(got) == 8
    for g, w in zip(got, want):
        # model FLOPs a device, the useful ratio and the peak are the
        # reference's; the times are its bytes and FLOPs at the card's
        assert g.model_flops == w.model_flops
        assert g.useful_ratio == w.useful_ratio
        assert g.peak_gib == w.peak_gib
        if g.status != "OK":
            assert g.note == w.note and len(g.note) <= 90
            continue
        assert g.compute_s * TA.PEAK_FLOPS == pytest.approx(
            w.compute_s * JA.PEAK_FLOPS, rel=1e-12)
        assert g.memory_s * TA.HBM_BW == pytest.approx(
            w.memory_s * JA.HBM_BW, rel=1e-12)
        assert g.collective_s * TA.LINK_BW == pytest.approx(
            w.collective_s * JA.LINK_BW, rel=1e-12)
        assert g.bound_time == max(g.compute_s, g.memory_s,
                                   g.collective_s)
        assert g.dominant == max((g.compute_s, "compute"),
                                 (g.memory_s, "memory"),
                                 (g.collective_s, "collective"))[1]
    deepfm = got[0]
    assert deepfm.hlo_flops == 5.0e12          # the counting lowering's
    assert deepfm.model_flops == TA.model_flops(
        TREG["deepfm"], TREG["deepfm"].shapes["train_batch"]) / 256
    md = TA.to_markdown(got)
    lines = md.split("\n")
    assert lines[:2] == JA.to_markdown(want).split("\n")[:2]
    assert len(lines) == 2 + len(got)
    assert "| deepfm | train_batch | single |" in md and "**" in md
    assert "| SKIP | - | - | pure full-attention arch |" in md
    assert TA.build_table(str(tmp_path / "missing")) == []


def test_roofline_row_fraction():
    row = TA.RooflineRow("a", "s", "single", 1.0, 4.0, 2.0, "memory", 0, 0,
                         0, 0, "OK")
    assert row.bound_time == 4.0 and row.roofline_fraction == 0.25
    zero = dataclasses.replace(row, compute_s=0.0, memory_s=0.0,
                               collective_s=0.0)
    assert zero.roofline_fraction == 0.0
