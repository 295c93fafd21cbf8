"""Port parity: the dry-run and what it needs (``repro_torch.launch.dryrun``,
``dist.sharding``, ``dist.constraints``, ``train.inputs.abstract_state`` /
``abstract_cache``, the ``meta`` branches of the kernels' wrappers).

Everything runs on the ``meta`` device: nothing is allocated or drawn, so
the full configs build here.  The sharding rules are held to the
reference's ``family_shardings`` / ``lm_cache_specs`` leaf by leaf on a
``jax.sharding.AbstractMesh`` of the production shapes (no devices); the
abstract state to its ``jax.eval_shape`` trees.  The reference's own
dry-run test fails on this jax, so the port's counts are held to hand
counts of the products instead, and the depth and microbatch
extrapolation to full-depth counts.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro  # noqa: F401
from repro.configs.registry import REGISTRY as JREG
from repro.configs.registry import all_cells as j_all_cells
from repro.dist import sharding as JSH
from repro.dist.pagerank_dist import distributed_in_shardings as j_in_sh
from repro.dist.pagerank_dist import distributed_input_specs as j_in_specs
from repro.graph.partition import edges_per_device as j_edges_per_device
from repro.train import inputs as JI

from repro_torch.configs.registry import REGISTRY as TREG
from repro_torch.configs.registry import get_arch
from repro_torch.dist import constraints as C
from repro_torch.dist import sharding as TSH
from repro_torch.dist.pagerank_dist import (distributed_in_shardings,
                                            distributed_input_specs)
from repro_torch.graph.partition import edges_per_device
from repro_torch.kernels import work
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_meta_mesh
from repro_torch.models.tree import tree_leaves
from repro_torch.roofline import analysis as RA
from repro_torch.train import inputs as TI

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
MODEL_CELLS = [(spec.arch_id, cell.name) for spec, cell in j_all_cells()
               if not cell.skip]


def _norm(spec) -> tuple:
    """A spec without trailing Nones (``P("model", None) == P("model")``
    in what it places)."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _dtype(t) -> str:
    return str(t.dtype).split(".")[-1]


# ---------------------------------------------------------------------------
# sharding rules, leaf by leaf against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharding_rules_match_reference(mesh_name):
    """``family_shardings`` (params, batch, optimizer state) and
    ``lm_cache_specs`` equal the reference's for every leaf of every
    non-pagerank cell at the full configs, on the production mesh."""
    shape, axes = MESHES[mesh_name]
    am, tm = AbstractMesh(shape, axes), make_meta_mesh(shape)
    n_leaves = n_split = 0
    for arch_id, cell_name in MODEL_CELLS:
        jspec, tspec = JREG[arch_id], TREG[arch_id]
        cell = jspec.shapes[cell_name]
        jp, jo = JI.abstract_state(jspec, cell)
        tp, to = TI.abstract_state(tspec, cell)
        jb, tb = JI.build_inputs(jspec, cell), TI.build_inputs(tspec, cell)
        pairs = list(zip(JSH.family_shardings(jspec.family, am, jp, jb, jo),
                         TSH.family_shardings(tspec.family, tm, tp, tb,
                                              to)))
        if cell.kind == "decode":
            pairs.append((JSH.lm_cache_specs(am, JI.abstract_cache(
                jspec, cell), cell.dims["batch"]),
                TSH.lm_cache_specs(tm, TI.abstract_cache(tspec, cell),
                                   cell.dims["batch"])))
        for want, got in pairs:
            want = jax.tree_util.tree_leaves(want)
            got = D._spec_leaves(got)
            assert len(got) == len(want), (arch_id, cell_name)
            for a, b in zip(want, got):
                assert b.mesh is tm
                assert _norm(b.spec) == _norm(a.spec), \
                    (arch_id, cell_name, a.spec, b.spec)
                n_leaves += 1
                n_split += any(x is not None for x in b.spec)
    assert n_leaves > 2000 and n_split > 500


def test_distributed_specs_and_edges_per_device_match_reference():
    """``distributed_in_shardings`` and ``distributed_input_specs``
    (shapes and dtypes, as meta tensors) on both production meshes, and
    ``edges_per_device``, equal the reference's."""
    for shape, axes in MESHES.values():
        am, tm = AbstractMesh(shape, axes), make_meta_mesh(shape)
        assert [_norm(s.spec) for s in distributed_in_shardings(tm)] == \
            [_norm(s.spec) for s in j_in_sh(am)]
        for cell in TREG["df-pagerank"].shapes.values():
            d = cell.dims
            got = distributed_input_specs(tm, d["n_vertices"],
                                          d["edge_capacity"])
            want = j_in_specs(am, d["n_vertices"], d["edge_capacity"])
            for a, b in zip(got, want):
                assert a.device.type == "meta"
                assert tuple(a.shape) == tuple(b.shape)
                assert _dtype(a) == str(b.dtype)
    for cap, m, p in [(0, 1, 1), (1, 1, 1), (40_000_000, 16, 32),
                      (1_980_000_000, 16, 16), (1000, 3, 7), (129, 1, 1)]:
        assert edges_per_device(cap, m, p) == j_edges_per_device(cap, m, p)
        assert edges_per_device(cap, m, p, lane=8) == \
            j_edges_per_device(cap, m, p, lane=8)


# nequip's embed and mix_v are f64 in the reference under x64; the port
# trains NequIP in f32 (ROADMAP.md queue 3, differences by design)
F64_BY_DESIGN = {"nequip": 6}


def test_abstract_state_and_cache_match_reference():
    """``abstract_state`` (parameters and optimizer state, the arch's
    moment dtype and factored second moments) and ``abstract_cache`` have
    the shapes and dtypes of the reference's ``jax.eval_shape`` trees, on
    ``meta``, for every non-pagerank cell at the full config."""
    for arch_id, cell_name in MODEL_CELLS:
        jspec, tspec = JREG[arch_id], TREG[arch_id]
        cell = jspec.shapes[cell_name]
        jp, jo = JI.abstract_state(jspec, cell)
        tp, to = TI.abstract_state(tspec, cell)
        want = jax.tree_util.tree_leaves((jp, jo))
        got = D._leaves(tp) + [to.step] + tree_leaves(to.m) \
            + tree_leaves(to.v)
        assert len(got) == len(want), arch_id
        f64 = 0
        for a, b in zip(got, want):
            assert a.device.type == "meta"
            assert tuple(a.shape) == tuple(b.shape), (arch_id, cell_name)
            if _dtype(a) != str(b.dtype):
                assert (_dtype(a), str(b.dtype)) == ("float32", "float64")
                f64 += 1
        assert f64 == F64_BY_DESIGN.get(arch_id, 0), (arch_id, f64)
        p2, none = TI.abstract_state(tspec, cell, with_opt=False)
        assert none is None and len(D._leaves(p2)) == len(D._leaves(tp))
        if cell.kind == "decode":
            want = jax.tree_util.tree_leaves(JI.abstract_cache(jspec, cell))
            got = tree_leaves(TI.abstract_cache(tspec, cell))
            assert [(tuple(a.shape), _dtype(a)) for a in got] == \
                [(tuple(b.shape), str(b.dtype)) for b in want]


# ---------------------------------------------------------------------------
# constraints, the collective parser
# ---------------------------------------------------------------------------

def test_resolve_and_data_shards_under_use_mesh():
    """Logical names resolve against the active mesh as the reference's
    ``_resolve`` does; ``data_shards`` is the data axes' size (1 with no
    mesh); ``constrain`` checks its names and returns ``x``."""
    assert C.active_mesh() is None and C.data_shards() == 1
    two, three = make_meta_mesh((4, 2)), make_meta_mesh((2, 3, 2))
    with C.use_mesh(two):
        assert C.active_mesh() is two
        assert C._resolve("batch", two) == ("data",)
        assert C._resolve("tp", two) == ("model",)
        assert C._resolve("full", two) == ("data", "model")
        assert C._resolve("pod", two) == ()
        assert C._resolve(None, two) == ()
        assert C.data_shards() == 4
        with C.use_mesh(three):
            assert C._resolve("batch", three) == ("pod", "data")
            assert C._resolve("full", three) == ("pod", "data", "model")
            assert C.data_shards() == 6
        assert C.active_mesh() is two
        x = torch.empty(8, 6, device="meta")
        assert C.constrain(x, "batch", "tp") is x
        with pytest.raises(ValueError, match="axes for a tensor"):
            C.constrain(x, "batch", None, "tp")
        with pytest.raises(TypeError):
            C.constrain(x, 0)
    assert C.active_mesh() is None and C.data_shards() == 1


def test_collective_parser():
    """``collective_bytes`` on the reference's own test text
    (``tests/test_substrate.py::test_collective_parser``)."""
    hlo = """
      %ag = f32[128,64]{1,0} all-gather(%x), replica_groups={{0,1}}
      %ar.1 = (f32[16]{0}, f32[16]{0}) all-reduce(%a, %b), to_apply=%add
      %done = f32[8]{0} all-gather-done(%ag2)
      %start = f32[8]{0} all-gather-start(%y)
      %a2a = bf16[4,2]{1,0} all-to-all(%z)
    """
    out = D.collective_bytes(hlo)
    assert out["all-gather"] == 128 * 64 * 4 + 8 * 4
    assert out["all-reduce"] == 2 * 16 * 4
    assert out["all-to-all"] == 4 * 2 * 2
    assert out["total"] == 128 * 64 * 4 + 8 * 4 + 2 * 16 * 4 + 16
    assert out["op_counts"]["all-gather"] == 2


# ---------------------------------------------------------------------------
# cells on a small meta mesh, and the counters
# ---------------------------------------------------------------------------

SMALL_CELLS = [("qwen2.5-3b", "decode_32k", (4, 2)),
               ("graphsage-reddit", "minibatch_lg", (4, 2)),
               ("deepfm", "train_batch", (4, 2)),
               ("df-pagerank", "temporal_so", (2, 2, 2))]


@pytest.mark.parametrize("arch_id,cell_name,shape", SMALL_CELLS)
def test_run_cell_on_a_small_mesh(arch_id, cell_name, shape):
    """The reference test's four cells (one a family and multi-pod
    pagerank) on a small meta mesh: OK, FLOPs and bytes counted, the
    memory split, no collectives, no kernel launched."""
    spec = get_arch(arch_id)
    launches = _launches()
    rec = D.run_cell(spec, spec.shapes[cell_name], make_meta_mesh(shape),
                     "test", verbose=False)
    assert rec["status"] == "OK", rec
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    m = rec["memory"]
    assert m["argument_size_in_bytes"] > 0
    assert m["peak_per_device_bytes"] == \
        m["argument_size_in_bytes"] + m["temp_size_in_bytes"]
    assert rec["collectives"] is None
    assert (spec.family == "lm") == ("cost_counting" in rec)
    assert _launches() == launches


def _launches() -> dict:
    from repro_torch.kernels.pagerank_spmv import pagerank_spmv
    from repro_torch.kernels.pull_contrib import pull_contrib
    from repro_torch.kernels.segment_ops import segment_matmul
    from repro_torch.kernels.slot_count import slot_count
    from repro_torch.kernels.walk_repair import walk_repair
    out = {}
    for m in (pagerank_spmv, pull_contrib, segment_matmul, slot_count,
              walk_repair):
        out.update(m.LAUNCH_COUNTS)
    return out


def _small(arch_id, cell_name, dims, **cfg):
    """The arch at its smoke config (with ``cfg`` changed) and a cell of
    ``dims``."""
    spec = get_arch(arch_id)
    spec = dataclasses.replace(spec, config=dataclasses.replace(
        spec.smoke_config, **cfg))
    return spec, dataclasses.replace(spec.shapes[cell_name], dims=dims)


def test_counted_flops_of_a_dense_lm_are_its_products():
    """qwen2.5-3b's smoke config (2 layers, D 64, 4/2 heads of 16, F 96,
    V 512) on a train cell of 2 x 64 in the counting mode: the FLOPs are
    three times the forward's products (every product's two operands take
    a gradient) and the embedding backward's ``pull_rows`` adds; the
    prefill cell's are the forward's with the last position's head."""
    spec, cell = _small("qwen2.5-3b", "train_4k", dict(seq=64, batch=2))
    cfg = spec.config
    b, s, d, h, kvh, hd, f, v = 2, 64, 64, 4, 2, 16, 96, 512
    t = b * s
    layer = (2 * t * d * (h + 2 * kvh) * hd + 2 * t * h * hd * d
             + 4 * b * h * s * s * hd + 3 * 2 * t * d * f)
    fwd = cfg.n_layers * layer + 2 * t * d * v
    c = D.count(D.lower_cell(spec, cell, make_meta_mesh((1, 1)),
                             counting=True), make_meta_mesh((1, 1)), False)
    assert c["flops"] == 3 * fwd + d * t
    assert c["kernels"] == {"pull_rows": 1, "segment_bounds": 1}
    spec, cell = _small("qwen2.5-3b", "prefill_32k", dict(seq=64, batch=2))
    c = D.count(D.lower_cell(spec, cell, make_meta_mesh((1, 1)),
                             counting=True), make_meta_mesh((1, 1)), False)
    assert c["flops"] == cfg.n_layers * layer + 2 * b * d * v


def test_counted_flops_of_deepfm_are_its_products():
    """DeepFM at its full widths (39 fields, d 10, MLP 390-400-400-400-1)
    on a train cell of 64: three times the MLP's forward products, and
    the two table gradients' ``pull_rows`` adds (d = 10 and 1 a slot);
    retrieval: one matrix-vector product."""
    spec = get_arch("deepfm")
    mesh = make_meta_mesh((1, 1))
    cfg, b = spec.config, 64
    dims = (cfg.n_sparse * cfg.embed_dim,) + cfg.mlp_dims + (1,)
    mlp = sum(2 * b * x * y for x, y in zip(dims[:-1], dims[1:]))
    cell = dataclasses.replace(spec.shapes["train_batch"], dims=dict(
        batch=b))
    c = D.count(D.lower_cell(spec, cell, mesh), mesh)
    assert c["flops"] == 3 * mlp + (cfg.embed_dim + 1) * b * cfg.n_sparse
    c = D.count(D.lower_cell(spec, spec.shapes["retrieval_cand"], mesh),
                mesh)
    assert c["flops"] == 2 * 1_000_000 * cfg.embed_dim


def test_counter_equals_flop_counter_and_mem_tracker():
    """The one-mode ``Counter`` counts the products as
    ``FlopCounterMode`` does and tracks the peak as ``MemTracker`` does,
    on DeepFM's and a GraphSAGE train cell."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    mesh = make_meta_mesh((4, 2))
    for arch_id, cell_name in (("deepfm", "train_batch"),
                               ("graphsage-reddit", "minibatch_lg")):
        spec = get_arch(arch_id)
        low = D.lower_cell(spec, spec.shapes[cell_name], mesh)
        c = D.count(low, mesh)
        kernel_flops = work.WORK["flops"]
        low = D.lower_cell(spec, spec.shapes[cell_name], mesh)
        tensors = [t for a in low.args for t in D._leaves(a)
                   if isinstance(t, torch.Tensor)]
        tracker, flops = MemTracker(), FlopCounterMode(display=False)
        tracker.track_external(*tensors)
        with C.use_mesh(mesh), tracker, flops:
            low.fn(*low.args)
        peak = sum(snap["Total"] for snap in
                   tracker.get_tracker_snapshot("peak").values())
        assert c["flops"] - kernel_flops == flops.get_total_flops()
        assert c["peak"] == peak


def _full(spec, cell, counting):
    mesh = make_meta_mesh((1, 1))
    return D.count(D.lower_cell(spec, cell, mesh, counting=counting), mesh,
                   not counting)


@pytest.mark.parametrize("arch_id,cell_name,dims,cfg,peak", [
    ("qwen2.5-3b", "train_4k", dict(seq=256, batch=4), dict(n_layers=4),
     True),
    ("qwen2.5-3b", "decode_32k", dict(ctx=32, batch=2), dict(n_layers=3),
     True),
    ("gemma3-12b", "prefill_32k", dict(seq=48, batch=1),
     dict(n_layers=8, global_every=6), False),
    ("arctic-480b", "train_4k", dict(seq=16, batch=16), dict(n_layers=2),
     False),
])
def test_depth_and_microbatch_extrapolation_equal_full_counts(
        arch_id, cell_name, dims, cfg, peak):
    """``depth_counts`` (cells of 1 and 2 layers, a global layer for a
    sliding window, 2 and 3 of arctic's 16 microbatches) equals counting
    the whole cell: FLOPs and bytes in both modes; and the production
    variant's peak where one phase of the step holds it at every depth
    (here the activations': at arctic's 16 microbatches of one 16-token
    row the optimizer's update of the stacked leaves holds it, and that
    peak is not affine from one layer on)."""
    spec, cell = _small(arch_id, cell_name, dims, **cfg)
    mesh = make_meta_mesh((1, 1))
    for counting in (True, False):
        got, method = D.depth_counts(spec, cell, mesh, counting=counting)
        want = _full(spec, cell, counting)
        assert got["flops"] == want["flops"], (counting, method)
        assert got["bytes"] == want["bytes"], (counting, method)
        if not counting and peak:
            assert got["peak"] == want["peak"], method
    assert ("global" in method) == (spec.config.window is not None)
    assert ("microbatches" in method) == (arch_id == "arctic-480b")


def test_main_writes_records_build_table_reads(tmp_path, monkeypatch,
                                               capsys):
    """``main`` on a small mesh (``REPRO_DRYRUN_DEVICES``) writes both
    meshes' records in the reference's schema (a SKIP where the cell
    says), resumes from them, and ``build_table`` reads them with the
    collective term n/a."""
    monkeypatch.setenv("REPRO_DRYRUN_DEVICES", "8")
    out = str(tmp_path / "ok")
    args = ["--mesh", "both", "--arch", "qwen2.5-3b", "--shape",
            "decode_32k", "--out", out]
    assert D.main(args) == 0
    for mesh_name in ("single", "multi"):
        with open(f"{out}/dryrun_{mesh_name}.json") as f:
            (rec,) = json.load(f)
        assert rec["status"] == "OK" and rec["mesh"] == mesh_name
        assert rec["counting_method"] == "delta L=1/2 -> L=36"
        assert rec["cost_counting"]["flops"] == rec["cost"]["flops"]
    assert D.main(args) == 0
    assert "cached qwen2.5-3b/decode_32k" in capsys.readouterr().out
    skip = str(tmp_path / "skip")
    assert D.main(["--arch", "qwen2.5-3b", "--shape", "long_500k",
                   "--out", skip]) == 0
    with open(f"{skip}/dryrun_single.json") as f:
        (rec,) = json.load(f)
    assert rec["status"] == "SKIP" and rec["skip_reason"]
    rows = RA.build_table(out) + RA.build_table(skip)
    assert [r.status for r in rows] == ["OK", "OK", "SKIP"]
    assert all(r.collective_s is None and r.dominant == "memory"
               and r.hlo_flops > 0 for r in rows[:2])
    md = RA.to_markdown(rows)
    assert md.count("| n/a |") == 2 and "SKIP" in md


# ---------------------------------------------------------------------------
# the kernels' meta branches
# ---------------------------------------------------------------------------

def test_kernel_meta_branches_match_plain_shapes_and_launch_nothing():
    """Each wrapper on ``meta`` tensors returns the shapes and dtypes its
    plain version returns on the CPU, records its work, and counts no
    launch."""
    from repro_torch.graph.structure import CSRView
    from repro_torch.kernels.pagerank_spmv import pagerank_spmv as P
    from repro_torch.kernels.pull_contrib import pull_contrib as PC
    from repro_torch.kernels.segment_ops import segment_matmul as SM
    from repro_torch.kernels.slot_count import slot_count as SC
    from repro_torch.kernels.walk_repair import walk_repair as W
    rng = np.random.default_rng(0)
    n, e = 50, 400
    src = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
    ok = torch.from_numpy(rng.random(e) < 0.8)
    ranks = torch.from_numpy(rng.random(n))
    x = torch.from_numpy(rng.standard_normal((n, 6)).astype(np.float32))
    packed = P.pack_blocks(src.numpy(), dst.numpy(), ok.numpy(), n, be=8,
                           vb=16, device="cpu")
    awin = torch.ones(packed.num_windows, dtype=torch.bool)
    rsc = torch.from_numpy(rng.random(n).astype(np.float32))
    from repro_torch.graph.structure import EdgeListGraph
    csr = EdgeListGraph(src, dst, ok, n).to_device_csr()
    rows = torch.from_numpy(rng.integers(0, n, (7, 5)).astype(np.int32))
    t0 = torch.zeros(7, dtype=torch.int32)
    ids = torch.arange(7, dtype=torch.int64)

    def meta(t):
        return t.to("meta") if isinstance(t, torch.Tensor) else t

    def on(dev_fn, args):
        return dev_fn(*[meta(a) for a in args])

    def both(fn, *args):
        return fn(*args), on(fn, args)

    def order(s, d, v):
        return PC.pull_order(s, d, v, n)

    o_cpu, o_meta = order(src, dst, ok), order(*map(meta, (src, dst, ok)))
    packed_meta = type(packed)(**{
        k: meta(getattr(packed, k)) for k in packed.__dataclass_fields__})
    csr_meta = CSRView(*map(meta, csr))
    cases = {
        "pull_contrib": (PC.pull_contrib(o_cpu, ranks, ranks),
                         PC.pull_contrib(o_meta, meta(ranks), meta(ranks))),
        "pull_rows": (PC.pull_rows(o_cpu, x),
                      PC.pull_rows(o_meta, meta(x))),
        "slot_count": both(lambda a, b: SC.slot_count(a, b, n), src, ok),
        "segment_bounds": (o_cpu.ptr, o_meta.ptr),
        "segment_or": (SC.segment_or(o_cpu.ptr, o_cpu.src, o_cpu.dst,
                                     ok[:n]),
                       SC.segment_or(o_meta.ptr, o_meta.src, o_meta.dst,
                                     meta(ok[:n]))),
        "frontier_spmv": (P.frontier_spmv_padded(packed, rsc, awin),
                          P.frontier_spmv_padded(packed_meta, meta(rsc),
                                                 meta(awin))),
        "gated_spmm": (SM.gated_spmm(packed, x, awin),
                       SM.gated_spmm(packed_meta, meta(x), meta(awin))),
        "walk_repair": (W.resample_rows(csr, rows, t0, (1, 2), ids,
                                        alpha=0.85),
                        W.resample_rows(csr_meta, meta(rows), meta(t0),
                                        (1, 2), meta(ids), alpha=0.85)),
    }
    for name, (cpu, met) in cases.items():
        assert met.device.type == "meta", name
        assert tuple(met.shape) == tuple(cpu.shape), name
        assert met.dtype == cpu.dtype, name
        assert work.WORK[name] >= 1, name
    assert work.WORK["bytes"] > 0 and work.WORK["flops"] > 0
    assert work.WORK["int_ops"] > 0
    assert not _launches()


def test_main_runs_cells_in_worker_processes(tmp_path, monkeypatch):
    """``main`` over several cells runs them in worker processes and
    records them in the cells' order, each equal to ``run_cell`` here
    (but for its timings)."""
    monkeypatch.setenv("REPRO_DRYRUN_DEVICES", "8")
    out = str(tmp_path)
    assert D.main(["--arch", "deepfm", "--out", out]) == 0
    with open(f"{out}/dryrun_single.json") as f:
        got = json.load(f)
    spec = TREG["deepfm"]
    mesh = D.make_mesh(False)
    timing = ("t_lower_s", "t_compile_s")
    assert [r["shape"] for r in got] == list(spec.shapes)
    for rec, cell in zip(got, spec.shapes.values()):
        want = D.run_cell(spec, cell, mesh, "single", verbose=False)
        assert rec["status"] == "OK"
        assert ({k: v for k, v in rec.items() if k not in timing}
                == {k: v for k, v in want.items() if k not in timing})
