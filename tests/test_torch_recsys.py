"""Port parity: the recsys family (``repro_torch.models.recsys``, its
steps, inputs, conversion and checkpoints) against ``repro``.

The four recsys cells of ``tests/test_archs_smoke.py`` at the smoke
config, on the reference's parameters carried across by ``convert``:
inputs bit for bit; the loss within rtol 1e-5; gradients, and parameters
and moments after 3 AdamW steps, within rtol 1e-4 / atol 1e-5·max (the
port sums each table row's gradient in ``pull_rows``' f32 order, the
FM's and the MLP's sums in torch's); serve's probabilities in [0, 1] and
retrieval's scores within rtol 1e-5 / atol 1e-6·max.  Then 3 steps at
the full config's widths on a cut vocabulary, ``embedding_bag`` in its
three modes (weights, an empty bag, gradients), the parameter count at
the full config, the meta inputs, and a DeepFM checkpoint written by one
package and restored by the other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.configs.registry import REGISTRY as JREG
from repro.configs.registry import all_cells as j_all_cells
from repro.ft import checkpoint as jckpt
from repro.models import recsys as JR
from repro.optim import adamw as jadamw
from repro.train import inputs as JI
from repro.train import steps as JS

from repro_torch import convert
from repro_torch.configs.registry import REGISTRY as TREG
from repro_torch.configs.registry import get_arch
from repro_torch.ft import checkpoint as tckpt
from repro_torch.launch import train as ttrain
from repro_torch.models import recsys as TR
from repro_torch.models.tree import tree_leaves
from repro_torch.optim import adamw as tadamw
from repro_torch.train import inputs as TI
from repro_torch.train import steps as TS
from test_torch_common import CPU, assert_bitwise, np_

CELLS = [cell.name for spec, cell in j_all_cells()
         if spec.family == "recsys"]
STEPS = 3


def _close(got, want, what, rtol=1e-4, atol_frac=1e-5):
    """rtol / atol = atol_frac · max|want|."""
    got, want = np_(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * scale + 1e-30, err_msg=what)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params(cfg):
    jp = JR.init_deepfm(cfg, jax.random.PRNGKey(0))
    return jp, convert.deepfm_params_from_numpy(_host(jp), device=CPU)


def _train_matches(jcfg, tcfg, jb, tb, jp, tp):
    """Loss and gradients, then STEPS AdamW steps, against the
    reference."""
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JR.deepfm_loss(jcfg, p, b["sparse_ids"], b["labels"])))(
            jp, jb)
    tl, tg = TS.value_and_grad(
        lambda p, b: TR.deepfm_loss(tcfg, p, b["sparse_ids"], b["labels"]),
        tp, tb)
    _close(tl, jl, "loss", rtol=1e-5, atol_frac=0.0)
    jgl = jax.tree_util.tree_leaves(jg)
    assert len(tg) == len(jgl) == len(tree_leaves(tp))
    for i, (a, b) in enumerate(zip(tg, jgl)):
        _close(a, b, f"grad leaf {i}")
    jstep = jax.jit(JS.make_recsys_train_step(jcfg))
    tstep = TS.make_recsys_train_step(tcfg)
    jo, to = jadamw.init_adamw(jp), tadamw.init_adamw(tp)
    for s in range(STEPS):
        jp, jo, jloss = jstep(jp, jo, jb)
        tp, to, tloss = tstep(tp, to, tb)
        _close(tloss, jloss, f"loss step {s}", rtol=1e-5, atol_frac=0.0)
    for i, (a, b) in enumerate(zip(tree_leaves(tp),
                                   jax.tree_util.tree_leaves(jp))):
        _close(a.detach(), b, f"param leaf {i} after {STEPS} steps")
    step, m, v = convert.adamw_state_to_numpy(to)
    assert step == int(jo.step) == STEPS
    for i, (a, b) in enumerate(zip(m + v, jax.tree_util.tree_leaves(jo.m)
                                   + jax.tree_util.tree_leaves(jo.v))):
        _close(a, b, f"moment leaf {i}")


def test_four_recsys_cells():
    assert CELLS == ["train_batch", "serve_p99", "serve_bulk",
                     "retrieval_cand"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_recsys_cell_matches_reference(cell_name):
    jspec, tspec = JREG["deepfm"], TREG["deepfm"]
    jcell, tcell = jspec.shapes[cell_name], tspec.shapes[cell_name]
    jcfg = JI.effective_config(jspec, jcell, True)
    tcfg = TI.effective_config(tspec, tcell, True)
    assert tcfg.__dict__ == jcfg.__dict__
    jb = JI.build_inputs(jspec, jcell, concrete=True, smoke=True, seed=1)
    tb = TI.build_inputs(tspec, tcell, concrete=True, smoke=True, seed=1,
                         device=CPU)
    assert sorted(jb) == sorted(tb)
    for k in jb:
        assert_bitwise(tb[k], jb[k], k)
    jp = JI.init_fn(jspec, True)(jax.random.PRNGKey(0))
    tp = convert.deepfm_params_from_numpy(_host(jp), device=CPU)
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert a.requires_grad
        assert_bitwise(a.detach(), np.asarray(b), "params")
    if jcell.kind == "recsys_train":
        _train_matches(jcfg, tcfg, jb, tb, jp, tp)
    elif jcell.kind == "recsys_serve":
        want = JS.make_recsys_serve(jcfg)(jp, jb)
        got = TS.make_recsys_serve(tcfg)(tp, tb)
        assert not got.requires_grad
        assert got.shape == (tb["sparse_ids"].shape[0],)
        assert bool(((got >= 0) & (got <= 1)).all())
        _close(got, want, "probabilities", rtol=1e-5, atol_frac=1e-6)
    else:
        want = JS.make_recsys_retrieval(jcfg)(jp, jb)
        got = TS.make_recsys_retrieval(tcfg)(tp, tb)
        assert got.shape == (tb["cand_ids"].shape[0],)
        _close(got, want, "scores", rtol=1e-5, atol_frac=1e-6)


def test_full_width_steps_on_a_cut_vocabulary():
    """The full config's widths (39 fields, embed_dim 10, MLP 400-400-400)
    on 50 rows a field and a batch of 64: loss, gradients, 3 steps."""
    jcfg = dataclasses.replace(JREG["deepfm"].config, vocab_per_field=50)
    tcfg = dataclasses.replace(TREG["deepfm"].config, vocab_per_field=50)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 50, (64, 39)).astype(np.int32)
    labels = (rng.random(64) < 0.5).astype(np.float32)
    jb = dict(sparse_ids=jnp.asarray(ids), labels=jnp.asarray(labels))
    tb = dict(sparse_ids=torch.from_numpy(ids),
              labels=torch.from_numpy(labels))
    jp, tp = _params(jcfg)
    _train_matches(jcfg, tcfg, jb, tb, jp, tp)


def test_param_count_and_meta_inputs_at_the_full_config():
    spec, jspec = get_arch("deepfm"), JREG["deepfm"]
    cfg = spec.config
    assert cfg.total_rows == 39_000_000
    assert cfg.param_count() == jspec.config.param_count() == 429_477_601
    # the count leaves out the scalar bias, in both packages
    params = TR.init_deepfm(dataclasses.replace(cfg, vocab_per_field=3),
                            torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in tree_leaves(params)) == \
        dataclasses.replace(cfg, vocab_per_field=3).param_count() + 1
    for name, cell in spec.shapes.items():
        jb = JI.build_inputs(jspec, jspec.shapes[name])
        tb = TI.build_inputs(spec, cell)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert tb[k].device.type == "meta"
            assert tuple(tb[k].shape) == tuple(jb[k].shape)
            assert str(tb[k].dtype).split(".")[-1] == str(jb[k].dtype)


def _bag_inputs():
    rng = np.random.default_rng(2)
    table = rng.standard_normal((40, 6)).astype(np.float32)
    ids = rng.integers(0, 40, 30).astype(np.int32)
    bags = rng.integers(0, 7, 30).astype(np.int32)
    bags[bags == 3] = 4                       # bag 3 is empty
    weights = rng.standard_normal(30).astype(np.float32)
    return table, ids, bags, weights


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_reference(mode, weighted):
    """Forward (an empty bag: 0, or -inf under max) and the table's
    gradient against the reference's."""
    table, ids, bags, weights = _bag_inputs()
    w = weights if weighted else None

    def jfn(t):
        return JR.embedding_bag(t, jnp.asarray(ids), jnp.asarray(bags), 8,
                                mode=mode, weights=None if w is None
                                else jnp.asarray(w))
    want = jfn(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_()
    got = TR.embedding_bag(tt, torch.from_numpy(ids), torch.from_numpy(bags),
                           8, mode=mode, weights=None if w is None
                           else torch.from_numpy(w))
    assert got.shape == (8, 6)
    empty = 3
    assert bool((got[empty] == (-np.inf if mode == "max" else 0.0)).all())
    np.testing.assert_array_equal(np.isinf(np_(got)), np.isinf(want))
    fin = np.isfinite(np.asarray(want))
    _close(np_(got)[fin], np.asarray(want)[fin], "bag rows", rtol=1e-5,
           atol_frac=1e-6)
    cot = np.where(fin, np.linspace(-1, 1, fin.size).reshape(fin.shape),
                   0.0).astype(np.float32)
    (jg,) = jax.vjp(jfn, jnp.asarray(table))[1](jnp.asarray(cot))
    (tg,) = torch.autograd.grad(got, tt, torch.from_numpy(cot))
    _close(tg, jg, "table gradient", rtol=1e-5, atol_frac=1e-6)


def test_embedding_bag_matches_manual():
    """The reference's own test, on the port."""
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32))
    ids = torch.tensor([3, 7, 7, 40, 2], dtype=torch.int32)
    bags = torch.tensor([0, 0, 1, 1, 2], dtype=torch.int32)
    out = TR.embedding_bag(table, ids, bags, 4, mode="sum")
    ref = np.zeros((4, 8), np.float32)
    for i, b in zip([3, 7, 7, 40, 2], [0, 0, 1, 1, 2]):
        ref[b] += table.numpy()[i]
    np.testing.assert_allclose(np_(out), ref, rtol=1e-6)
    mean = TR.embedding_bag(table, ids, bags, 4, mode="mean")
    assert np.allclose(np_(mean)[0], ref[0] / 2, rtol=1e-6)


def test_forward_shares_one_slot_order():
    """The two table gathers of a forward share one id tensor, so the
    backward builds one slot order for both."""
    from repro_torch.models import message
    cfg = TREG["deepfm"].smoke_config
    params = TR.init_deepfm(cfg, torch.Generator().manual_seed(0))
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_per_field, (16, cfg.n_sparse)).astype(np.int32))
    labels = torch.ones(16)
    before = message.ORDER_BUILDS["slot_order"]
    loss, grads = TS.value_and_grad(
        lambda p, b: TR.deepfm_loss(cfg, p, b[0], b[1]), params,
        (ids, labels))
    assert message.ORDER_BUILDS["slot_order"] - before == 1
    assert [tuple(g.shape) for g in grads] == \
        [tuple(p.shape) for p in tree_leaves(params)]


def test_deepfm_checkpoint_crosses_packages(tmp_path):
    """(DeepFMParams, AdamWState) a train step in: saved by the reference
    and restored by the port, then saved by the port and restored by the
    reference, bit for bit, under one manifest; ``convert`` back to the
    reference's nesting."""
    spec = JREG["deepfm"]
    cfg = spec.smoke_config
    jp = JI.init_fn(spec, True)(jax.random.PRNGKey(0))
    jb = JI.build_inputs(spec, spec.shapes["train_batch"], concrete=True,
                         smoke=True, seed=1)
    jp, jo, _ = jax.jit(JS.make_recsys_train_step(cfg))(
        jp, jadamw.init_adamw(jp), jb)
    jstate = (jp, jo)
    jleaves = jax.tree_util.tree_leaves(jstate)
    jckpt.save(str(tmp_path / "ref"), 1, jstate)
    params = TR.init_deepfm(TREG["deepfm"].smoke_config,
                            torch.Generator().manual_seed(3))
    target = ttrain.checkpoint_state(params, tadamw.init_adamw(params))
    step, got = tckpt.CheckpointManager(str(tmp_path / "ref")).\
        restore_latest(target, CPU)
    assert step == 1 and isinstance(got[0], TR.DeepFMParams)
    assert len(tree_leaves(got)) == len(jleaves) == 1 + 3 * 11
    for a, b in zip(tree_leaves(got), jleaves):
        assert_bitwise(a, np.asarray(b), "reference -> port")
    tckpt.save(str(tmp_path / "port"), 1, got)
    back = jckpt.restore(str(tmp_path / "port"), 1, jstate)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jstate)
    for a, b in zip(jax.tree_util.tree_leaves(back), jleaves):
        assert_bitwise(np.asarray(a), np.asarray(b), "port -> reference")
    host = convert.deepfm_params_to_numpy(TR.trainable(got[0]))
    assert host._fields == jp._fields
    assert (len(host.mlp_ws), len(host.mlp_bs)) == (len(jp.mlp_ws),
                                                    len(jp.mlp_bs))
    for a, b in zip(jax.tree_util.tree_leaves(host),
                    jax.tree_util.tree_leaves(jp)):
        assert_bitwise(a, np.asarray(b), "to_numpy")
