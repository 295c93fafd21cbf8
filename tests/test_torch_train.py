"""Port parity: the GNN family's training step (``repro_torch.train``,
``models.gnn``, ``optim``) against ``repro`` on every GNN (architecture ×
cell) of the reference's registry at its smoke config, the 16 GNN rows of
``tests/test_archs_smoke.py``.

For each cell: ``build_inputs(..., concrete=True, smoke=True, seed=1)``
bit for bit the reference's; the reference's parameters carried across
(leaf for leaf in ``jax.tree_util`` flatten order); the loss within rtol
1e-5; every gradient within rtol 1e-4 / atol 1e-5·max|g|; parameters and
AdamW moments after 3 steps within the same bound.  The port sums in
another f32 order (``pull_rows``' chunks) and runs NequIP in f32 where
the reference's ``embed`` and ``mix_v`` are f64.  PNA's std aggregator
has an infinite gradient at zero variance, so some of its gradients are
NaN in both packages: NaN must stand where the reference's does.

Then the sampler's blocks (bit for bit for one seed), ``adamw_update``
factored and unfactored, ``warmup_cosine``, ``compress_tree`` and the
registry's refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.configs.registry import REGISTRY as JREG
from repro.configs.registry import all_cells as j_all_cells
from repro.graph.sampling import NeighborSampler as JSampler
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim.schedules import warmup_cosine as j_warmup_cosine
from repro.train import inputs as JI
from repro.train import steps as JS

from repro_torch import convert
from repro_torch.configs.registry import REGISTRY as TREG
from repro_torch.configs.registry import NOT_PORTED, get_arch
from repro_torch.graph.sampling import NeighborSampler
from repro_torch.models.tree import tree_leaves
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train import inputs as TI
from repro_torch.train import steps as TS
from test_torch_common import CPU, assert_bitwise, np_

CELLS = [(spec.arch_id, cell.name) for spec, cell in j_all_cells()
         if spec.family == "gnn"]
STEPS = 3


def _close(got, want, what, rtol=1e-4, atol_frac=1e-5):
    """rtol / atol = atol_frac · max|want| (NaN where the reference has
    NaN)."""
    got, want = np_(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.nanmax(np.abs(want)) if np.isfinite(want).any() else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * scale + 1e-30,
                               equal_nan=True, err_msg=what)


def _pair(arch_id, cell_name):
    jspec, tspec = JREG[arch_id], TREG[arch_id]
    jcell, tcell = jspec.shapes[cell_name], tspec.shapes[cell_name]
    jcfg = JI.effective_config(jspec, jcell, True)
    tcfg = TI.effective_config(tspec, tcell, True)
    jb = JI.build_inputs(jspec, jcell, concrete=True, smoke=True, seed=1)
    tb = TI.build_inputs(tspec, tcell, concrete=True, smoke=True, seed=1,
                         device=CPU)
    jp = JI.init_fn(jspec, True)(jax.random.PRNGKey(0))
    tp = convert.gnn_params_from_numpy(
        arch_id, jax.tree_util.tree_map(np.asarray, jp), device=CPU)
    return jcfg, tcfg, jb, tb, jp, tp


@pytest.mark.parametrize("arch_id,cell_name", CELLS)
def test_gnn_cell_trains_like_reference(arch_id, cell_name):
    jcfg, tcfg, jb, tb, jp, tp = _pair(arch_id, cell_name)
    assert tcfg == jcfg or tcfg.__dict__ == jcfg.__dict__
    # inputs bit for bit, leaf for leaf (lists of blocks included)
    assert sorted(jb) == sorted(tb)
    for k in sorted(jb):
        jl, tl = jax.tree_util.tree_leaves(jb[k]), tree_leaves(tb[k])
        assert len(jl) == len(tl), k
        for a, b in zip(tl, jl):
            assert_bitwise(a, b, f"input {k}")
    # parameters carried across in flatten order
    jleaves = jax.tree_util.tree_leaves(jp)
    tleaves = tp.leaves()
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        assert a.requires_grad
        assert_bitwise(a.detach(), np.asarray(b).astype(np.float32),
                       "params")
    # loss and every gradient
    jl, jg = jax.value_and_grad(JS.make_gnn_loss(arch_id, jcfg))(jp, jb)
    tl, tg = TS.value_and_grad(TS.make_gnn_loss(arch_id, tcfg), tp, tb)
    _close(tl, jl, "loss", rtol=1e-5, atol_frac=0.0)
    for i, (a, b) in enumerate(zip(tg, jax.tree_util.tree_leaves(jg))):
        _close(a, b, f"grad leaf {i}")
    # three AdamW steps: parameters and moments
    jstep = jax.jit(JS.make_gnn_train_step(arch_id, jcfg))
    tstep = TS.make_gnn_train_step(arch_id, tcfg)
    jo = jadamw.init_adamw(jp)
    to = tadamw.init_adamw(tp)
    for s in range(STEPS):
        jp, jo, jloss = jstep(jp, jo, jb)
        tp, to, tloss = tstep(tp, to, tb)
        _close(tloss, jloss, f"loss step {s}", rtol=1e-5, atol_frac=0.0)
    for i, (a, b) in enumerate(zip(tp.leaves(),
                                   jax.tree_util.tree_leaves(jp))):
        _close(a.detach(), b, f"param leaf {i} after {STEPS} steps")
    step, m, v = convert.adamw_state_to_numpy(to)
    assert step == int(jo.step) == STEPS
    for i, (a, b) in enumerate(zip(m, jax.tree_util.tree_leaves(jo.m))):
        _close(a, b, f"m leaf {i}")
    for i, (a, b) in enumerate(zip(v, jax.tree_util.tree_leaves(jo.v))):
        _close(a, b, f"v leaf {i}")


def test_train_step_carries_a_reference_state():
    """A reference AdamW state mid-run carries across and the next step
    agrees (graphcast, the most leaves of any GNN)."""
    jcfg, tcfg, jb, tb, jp, tp = _pair("graphcast", "full_graph_sm")
    jstep = jax.jit(JS.make_gnn_train_step("graphcast", jcfg))
    jo = jadamw.init_adamw(jp)
    for _ in range(2):
        jp, jo, _ = jstep(jp, jo, jb)
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tp = convert.gnn_params_from_numpy("graphcast", host(jp), device=CPU)
    to = convert.adamw_state_from_numpy(host(jp), jo.step, host(jo.m),
                                        host(jo.v), device=CPU)
    # and back: the reference's nesting and leaves
    back = convert.gnn_params_to_numpy(tp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(host(jp))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        assert_bitwise(a, np.asarray(b), "params round trip")
    jp, jo, jloss = jstep(jp, jo, jb)
    tp, to, tloss = TS.make_gnn_train_step("graphcast", tcfg)(tp, to, tb)
    _close(tloss, jloss, "loss", rtol=1e-5, atol_frac=0.0)
    for a, b in zip(tp.leaves(), jax.tree_util.tree_leaves(jp)):
        _close(a.detach(), b, "param")


def test_train_step_needs_no_host_read(monkeypatch):
    """Nothing of a step reads the device back: a CPU run of the step
    records no host sync (``device.note_host_syncs`` call sites)."""
    from repro_torch.device import host_sync_count
    _, tcfg, _, tb, _, tp = _pair("graphsage-reddit", "minibatch_lg")
    step = TS.make_gnn_train_step("graphsage-reddit", tcfg)
    opt = tadamw.init_adamw(tp)
    before = host_sync_count()
    step(tp, opt, tb)
    assert host_sync_count() == before


# ---------------------------------------------------------------------------
# sampler, optimizer, schedule, compression, registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5])
def test_neighbor_sampler_blocks_bitwise(seed):
    from repro.graph.generators import rmat_edges
    edges, n = rmat_edges(9, 8, seed=2)
    order = np.argsort(edges[:, 0], kind="stable")
    src, dst = edges[order, 0], edges[order, 1]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    seeds = np.arange(0, n, 37)
    want = JSampler(indptr, dst, (5, 3), seed=seed).sample(seeds)
    got = NeighborSampler(indptr, dst, (5, 3), seed=seed).sample(seeds)
    assert_bitwise(got.seeds, want.seeds, "seeds")
    assert len(got.blocks) == len(want.blocks) == 2
    for a, b in zip(got.blocks, want.blocks):
        for f in ("nodes", "parent", "mask"):
            assert_bitwise(getattr(a, f), getattr(b, f), f)
    assert_bitwise(got.all_nodes, want.all_nodes, "all_nodes")
    assert_bitwise(got.all_mask, want.all_mask, "all_mask")


@pytest.mark.parametrize("factored", [False, True])
def test_adamw_update_matches_reference(factored, monkeypatch):
    """Factored (Adafactor rows/cols, a leaf past ``_FACTOR_MIN_SIZE``)
    and unfactored, with weight decay and a bf16 moment: 3 updates."""
    monkeypatch.setattr(jadamw, "_FACTOR_MIN_SIZE", 64)
    monkeypatch.setattr(tadamw, "_FACTOR_MIN_SIZE", 64)
    rng = np.random.default_rng(0)
    tree = dict(b=[rng.standard_normal((16, 8)).astype(np.float32),
                   rng.standard_normal((5,)).astype(np.float32)],
                a=rng.standard_normal((4, 3)).astype(np.float32))
    grads = [jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), tree)
        for _ in range(3)]
    for mdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        jo = jadamw.init_adamw(jp, moment_dtype=mdt, factored=factored)
        tp = [torch.from_numpy(a) for a in tree_leaves(tree)]
        to = tadamw.init_adamw(tp, moment_dtype=tdt, factored=factored)
        assert [isinstance(v, tuple) for v in to.v] == \
            [factored and x.size >= 64 and x.ndim >= 2
             for x in tree_leaves(tree)]
        for g in grads:
            lr = j_warmup_cosine(jo.step, peak_lr=1e-2, warmup_steps=1,
                                 total_steps=10)
            jp, jo = jadamw.adamw_update(jp, g, jo, lr=lr,
                                         factored=factored)
            tlr = warmup_cosine(to.step, peak_lr=1e-2, warmup_steps=1,
                                total_steps=10)
            tp, to = tadamw.adamw_update(
                tp, [torch.from_numpy(x) for x in tree_leaves(g)], to,
                lr=tlr, factored=factored)
        for a, b in zip(tp, jax.tree_util.tree_leaves(jp)):
            _close(a, b, "param", rtol=1e-6, atol_frac=1e-6)
        for a, b in zip(to.m, jax.tree_util.tree_leaves(jo.m)):
            _close(a.float(), np.asarray(b, np.float32), "m", rtol=1e-2
                   if tdt == torch.bfloat16 else 1e-6, atol_frac=1e-6)


def test_warmup_cosine_matches_reference():
    for step in (0, 1, 5, 10, 11, 500, 999, 1000, 5000):
        for kw in (dict(peak_lr=1e-3, warmup_steps=10, total_steps=1000),
                   dict(peak_lr=3e-4, warmup_steps=0, total_steps=1,
                        min_ratio=0.0)):
            want = np.asarray(j_warmup_cosine(jnp.asarray(step, jnp.int32),
                                              **kw))
            got = warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
            assert got.dtype == torch.float32
            assert abs(float(got) - float(want)) <= \
                2 ** -23 * abs(float(want)), (step, kw)


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_compress_tree_matches_reference(mode):
    rng = np.random.default_rng(3)
    tree = dict(w=rng.standard_normal((33, 7)).astype(np.float32) * 3,
                b=[rng.standard_normal((9,)).astype(np.float32)])
    want = jcomp.compress_tree(jax.tree_util.tree_map(jnp.asarray, tree),
                               mode)
    got = tcomp.compress_tree(
        {k: [torch.from_numpy(x) for x in v] if isinstance(v, list)
         else torch.from_numpy(v) for k, v in tree.items()}, mode)
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        a, b = np_(a), np.asarray(b)
        # bitwise, or within one ulp (the int8 scale's division)
        assert np.all(np.abs(a - b) <= np.spacing(np.abs(b))), mode
    q, s = tcomp.quantize_int8(torch.from_numpy(tree["w"]))
    jq, js = jcomp.quantize_int8(jnp.asarray(tree["w"]))
    assert q.dtype == torch.int8 and np.array_equal(np_(q), np.asarray(jq))
    with pytest.raises(ValueError, match="unknown compression mode"):
        tcomp.compress_tree({}, "fp4")


def test_registry_gnn_and_refusals():
    """The port's registry equals the reference's (the LM, GNN, recsys and
    PageRank families, in its order) and refuses no architecture:
    ``get_arch("deepfm")`` returns its spec and its cells build inputs.
    Nothing raises "not ported yet": the LM's counting mode (the
    dry-run's) runs and gives the production mode's hidden states; an
    unknown arch is a KeyError."""
    import dataclasses
    from repro_torch.models import transformer as TT
    assert list(TREG) == list(JREG)
    assert NOT_PORTED == {}
    for arch_id in TREG:
        assert TREG[arch_id].shapes.keys() == JREG[arch_id].shapes.keys()
        assert TREG[arch_id].family == JREG[arch_id].family
    spec = get_arch("deepfm")
    assert spec.family == "recsys"
    assert spec.config.__dict__ == JREG["deepfm"].config.__dict__
    assert spec.smoke_config.__dict__ == JREG["deepfm"].smoke_config.__dict__
    for cell in spec.shapes.values():
        assert TI.build_inputs(spec, cell, concrete=True, smoke=True,
                               device=CPU)
    cfg = dataclasses.replace(TREG["qwen2.5-3b"].smoke_config,
                              counting=True)
    params = TT.init_lm(cfg, torch.Generator())
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with torch.no_grad():
        counted, _ = TT.backbone(cfg, params, toks)
        production, _ = TT.backbone(
            dataclasses.replace(cfg, counting=False), params, toks)
    np.testing.assert_allclose(counted.numpy(), production.numpy(),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("gpt-2")


def test_meta_inputs_match_reference_shapes():
    """``concrete=False``: meta tensors of the reference's shapes and
    dtypes, at the full configs."""
    for arch_id, cell_name in CELLS:
        jspec, tspec = JREG[arch_id], TREG[arch_id]
        jb = JI.build_inputs(jspec, jspec.shapes[cell_name])
        tb = TI.build_inputs(tspec, tspec.shapes[cell_name])
        for a, b in zip(tree_leaves([tb[k] for k in sorted(tb)]),
                        jax.tree_util.tree_leaves([jb[k]
                                                   for k in sorted(jb)])):
            assert a.device.type == "meta"
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype).split(".")[-1] == str(b.dtype).replace(
                "bool", "bool")
