"""Port parity: the LM family (``repro_torch.models.transformer``,
``train.steps``) against ``repro`` on the 16 LM cells of
``tests/test_archs_smoke.py`` (5 architectures × train / prefill / decode
/ long_500k, less long_500k on the four full-attention ones) at the smoke
configs, on the reference's parameters carried across by ``convert``.

The smoke configs are f32; the port sums in other orders (chunked
attention's loop, ``pull_rows``' chunks for the embedding's and the MoE's
row sums), so: the loss within rtol 1e-5; parameters after one AdamW step
within rtol 1e-4 / atol 1e-5·max; prefill and decode logits within rtol
1e-5 / atol 1e-5·max.  Then decode against prefill (the reference's own
check), the loss falling over 30 steps, and the meta inputs' shapes and
dtypes at the full configs.
"""
import jax
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.configs.registry import REGISTRY as JREG
from repro.configs.registry import all_cells as j_all_cells
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.train import inputs as JI
from repro.train import steps as JS

from repro_torch import convert
from repro_torch.configs.registry import NOT_PORTED, REGISTRY as TREG
from repro_torch.configs.registry import get_arch
from repro_torch.data.lm import batches
from repro_torch.models import transformer as TT
from repro_torch.models.tree import tree_leaves
from repro_torch.optim import adamw as tadamw
from repro_torch.train import inputs as TI
from repro_torch.train import steps as TS
from test_torch_common import CPU, assert_bitwise, np_

CELLS = [(spec.arch_id, cell.name) for spec, cell in j_all_cells()
         if spec.family == "lm" and not cell.skip]


def _close(got, want, what, rtol=1e-4, atol_frac=1e-5):
    """rtol / atol = atol_frac · max|want|."""
    got, want = np_(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * scale + 1e-30, err_msg=what)


def _params(arch_id):
    jp = JI.init_fn(JREG[arch_id], True)(jax.random.PRNGKey(0))
    tp = convert.lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device=CPU)
    return jp, tp


def test_sixteen_lm_cells():
    assert len(CELLS) == 16


@pytest.mark.parametrize("arch_id,cell_name", CELLS)
def test_lm_cell_matches_reference(arch_id, cell_name):
    jspec, tspec = JREG[arch_id], TREG[arch_id]
    jcell, tcell = jspec.shapes[cell_name], tspec.shapes[cell_name]
    jcfg = JI.effective_config(jspec, jcell, True)
    tcfg = TI.effective_config(tspec, tcell, True)
    assert tcfg.__dict__ == jcfg.__dict__
    jb = JI.build_inputs(jspec, jcell, concrete=True, smoke=True, seed=1)
    tb = TI.build_inputs(tspec, tcell, concrete=True, smoke=True, seed=1,
                         device=CPU)
    assert sorted(jb) == sorted(tb)
    jp, tp = _params(arch_id)
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        assert a.requires_grad
        assert_bitwise(a.detach(), np.asarray(b), "params")
    if jcell.kind == "train":
        for k in ("tokens", "labels"):
            assert_bitwise(tb[k], jb[k], k)
        jp2, jo2, jloss = jax.jit(JS.make_lm_train_step(jcfg))(
            jp, jadamw.init_adamw(jp), jb)
        tp2, to2, tloss = TS.make_lm_train_step(tcfg)(
            tp, tadamw.init_adamw(tp), tb)
        _close(tloss, jloss, "loss", rtol=1e-5, atol_frac=0.0)
        for i, (a, b) in enumerate(zip(tree_leaves(tp2),
                                       jax.tree_util.tree_leaves(jp2))):
            _close(a.detach(), b, f"param leaf {i} after a step")
        assert int(to2.step) == int(jo2.step) == 1
    elif jcell.kind == "prefill":
        assert_bitwise(tb["tokens"], jb["tokens"], "tokens")
        want = JS.make_lm_prefill(jcfg)(jp, jb["tokens"])
        got = TS.make_lm_prefill(tcfg)(tp, tb["tokens"])
        assert got.shape == (tb["tokens"].shape[0], tcfg.vocab)
        _close(got, want, "prefill logits", rtol=1e-5)
    else:
        assert (tb["batch"], tb["ctx"]) == (jb["batch"], jb["ctx"])
        assert_bitwise(tb["tokens"], jb["tokens"], "tokens")
        jc = JT.init_cache(jcfg, jb["batch"], jb["ctx"], length=5)
        tc = TT.init_cache(tcfg, tb["batch"], tb["ctx"], length=5,
                           device=CPU)
        want, jc2 = JS.make_lm_decode_step(jcfg)(jp, jc, jb["tokens"])
        got, tc2 = TS.make_lm_decode_step(tcfg)(tp, tc, tb["tokens"])
        assert got.shape == (tb["batch"], 1, tcfg.vocab)
        _close(got, want, "decode logits", rtol=1e-5)
        assert int(tc2.length) == int(jc2.length) == 6
        # written in place: the returned cache is the given one
        assert tc2.k is tc.k and tc2.v is tc.v
        _close(tc2.k, jc2.k, "cache k", rtol=1e-5)
        _close(tc2.v, jc2.v, "cache v", rtol=1e-5)


def test_decode_matches_prefill_logits():
    """Decoding token by token equals the forward at the same position
    (the reference's test, on the port)."""
    cfg = TREG["qwen2.5-3b"].smoke_config
    gen = torch.Generator()
    gen.manual_seed(0)
    params = TT.init_lm(cfg, gen)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    with torch.no_grad():
        full, _ = TT.forward(cfg, params, toks)
    cache = TT.init_cache(cfg, 2, 16, device=CPU)
    for t in range(8):
        logits, cache = TT.decode_step(cfg, params, cache, toks[:, t:t + 1])
    np.testing.assert_allclose(np_(logits[:, 0]), np_(full[:, -1]),
                               rtol=2e-3, atol=2e-3)
    last = TS.make_lm_prefill(cfg)(params, toks)
    np.testing.assert_allclose(np_(last), np_(full[:, -1]), rtol=1e-6,
                               atol=1e-5)


def test_lm_train_loss_decreases():
    """30 steps on the reduced config reduce the loss (the reference's
    test, on the port's own parameters and corpus)."""
    cfg = TREG["qwen2.5-3b"].smoke_config
    gen = torch.Generator()
    gen.manual_seed(0)
    params = TT.init_lm(cfg, gen)
    opt = tadamw.init_adamw(params)
    step = TS.make_lm_train_step(cfg, peak_lr=2e-3, warmup=5, total=60)
    data = batches(cfg.vocab, 8, 64, seed=3)
    losses = []
    for _ in range(30):
        b = {k: torch.from_numpy(v) for k, v in next(data).items()}
        params, opt, loss = step(params, opt, b)
        losses.append(float(loss))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


def test_registry_resolves_the_lm_family():
    for arch_id in ("gemma3-12b", "qwen2.5-3b", "glm4-9b",
                    "qwen3-moe-30b-a3b", "arctic-480b"):
        spec = get_arch(arch_id)
        assert spec.family == "lm"
        assert spec.config.__dict__ == JREG[arch_id].config.__dict__
        assert spec.smoke_config.__dict__ == \
            JREG[arch_id].smoke_config.__dict__
        assert spec.notes == JREG[arch_id].notes
        assert {k: v.__dict__ for k, v in spec.shapes.items()} == \
            {k: v.__dict__ for k, v in JREG[arch_id].shapes.items()}
        c, jc = spec.config, JREG[arch_id].config
        assert c.param_count() == jc.param_count()
        assert c.active_param_count() == jc.active_param_count()
    assert list(TREG) == list(JREG)
    assert NOT_PORTED == {}
    assert get_arch("deepfm").config.__dict__ == \
        JREG["deepfm"].config.__dict__


def test_meta_lm_inputs_match_reference_shapes():
    """``concrete=False``: meta tensors of the reference's shapes and
    dtypes at the full configs (decode's ``ctx`` and ``batch`` equal)."""
    for spec, cell in j_all_cells():
        if spec.family != "lm":
            continue
        jb = JI.build_inputs(spec, cell)
        tb = TI.build_inputs(TREG[spec.arch_id], cell)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            if isinstance(jb[k], int):
                assert tb[k] == jb[k]
                continue
            assert tb[k].device.type == "meta"
            assert tuple(tb[k].shape) == tuple(jb[k].shape)
            assert str(tb[k].dtype).split(".")[-1] == str(jb[k].dtype)


COUNTING = ["qwen2.5-3b", "qwen3-moe-30b-a3b"]


def _modes(arch_id):
    """The smoke config in the production and the counting mode (port),
    the reference's counting config, and the train cell's inputs."""
    import dataclasses
    jspec, tspec = JREG[arch_id], TREG[arch_id]
    cell = jspec.shapes["train_4k"]
    tcfg = TI.effective_config(tspec, cell, True)
    jcount = dataclasses.replace(JI.effective_config(jspec, cell, True),
                                 counting=True)
    tcount = dataclasses.replace(tcfg, counting=True)
    jb = JI.build_inputs(jspec, cell, concrete=True, smoke=True, seed=1)
    tb = TI.build_inputs(tspec, cell, concrete=True, smoke=True, seed=1,
                         device=CPU)
    return tcfg, tcount, jcount, jb, tb


@pytest.mark.parametrize("arch_id", COUNTING)
def test_counting_loss_and_gradients_match(arch_id):
    """The counting mode (layers unchecked, attention in one chunk, the
    full-logit loss): loss rtol 1e-5 and gradients rtol 1e-4 / atol
    1e-5·max against the reference's counting mode and against the port's
    production mode."""
    tcfg, tcount, jcount, jb, tb = _modes(arch_id)
    jp, tp = _params(arch_id)
    jloss, jg = jax.jit(jax.value_and_grad(lambda p: JT.lm_loss(
        jcount, p, jb["tokens"], jb["labels"])))(jp)
    got = {}
    for name, cfg in (("counting", tcount), ("production", tcfg)):
        got[name] = TS.value_and_grad(
            lambda p, b, cfg=cfg: TT.lm_loss(cfg, p, b["tokens"],
                                             b["labels"]), tp, tb)
    for loss, grads in (got["counting"], got["production"]):
        _close(loss, jloss, "loss", rtol=1e-5, atol_frac=0.0)
        for i, (a, b) in enumerate(zip(grads,
                                       jax.tree_util.tree_leaves(jg))):
            _close(a, b, f"gradient leaf {i}")
    _close(got["counting"][0], np_(got["production"][0]), "loss",
           rtol=1e-5, atol_frac=0.0)
    for i, (a, b) in enumerate(zip(*(g[1] for g in got.values()))):
        _close(a, np_(b), f"gradient leaf {i}, counting vs production")


@pytest.mark.parametrize("arch_id", COUNTING)
def test_counting_prefill_and_decode_match(arch_id):
    """Prefill logits and two decode steps of the counting mode against
    the reference's counting mode and the port's production mode, rtol
    1e-5 / atol 1e-5·max."""
    tcfg, tcount, jcount, jb, tb = _modes(arch_id)
    jp, tp = _params(arch_id)
    toks = tb["tokens"]
    want = jax.jit(JS.make_lm_prefill(jcount))(jp, jb["tokens"])
    for cfg in (tcount, tcfg):
        _close(TS.make_lm_prefill(cfg)(tp, toks), want, "prefill logits",
               rtol=1e-5)
    jc = JT.init_cache(jcount, 2, 16, length=5)
    jstep = jax.jit(JS.make_lm_decode_step(jcount))
    caches = {cfg: TT.init_cache(cfg, 2, 16, length=5, device=CPU)
              for cfg in (tcount, tcfg)}
    for t in range(2):
        step = jb["tokens"][:, t:t + 1]
        want, jc = jstep(jp, jc, step)
        for cfg in (tcount, tcfg):
            got, caches[cfg] = TS.make_lm_decode_step(cfg)(
                tp, caches[cfg], toks[:, t:t + 1])
            _close(got, want, f"decode logits, step {t}", rtol=1e-5)
    for cfg in (tcount, tcfg):
        _close(caches[cfg].k, jc.k, "cache k", rtol=1e-5)
        assert int(caches[cfg].length) == int(jc.length) == 7


def test_moe_ffn_ranks_within_two_data_shards(monkeypatch):
    """Under a mesh of two data shards the MoE ranks its (token, k) pairs
    within each shard, with half the capacity each, as the reference does:
    the reference's ``moe_ffn`` with its ``data_shards`` patched to 2
    against the port's under ``use_mesh`` of a (2, 1) mesh; output rtol
    1e-4 / atol 1e-5·max, aux rtol 1e-5.  It drops other pairs than one
    shard does, so the outputs differ from the one-shard outputs."""
    import jax.numpy as jnp
    from repro.models import moe as JM
    from repro_torch.dist.constraints import data_shards, use_mesh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe as TM
    d, f, e, top_k, t = 16, 24, 4, 2, 8
    jp = JM.init_moe(jax.random.PRNGKey(3), d, f, e, dtype=jnp.float32)
    tp = TM.MoEParams(*(torch.from_numpy(np.array(a)) for a in jp))
    x = np.random.default_rng(4).standard_normal((t, d)).astype(np.float32)
    one, _ = TM.moe_ffn(tp, torch.from_numpy(x), top_k)
    monkeypatch.setattr(JM, "data_shards", lambda: 2)
    want, jaux = jax.jit(JM.moe_ffn, static_argnums=2)(jp, jnp.asarray(x),
                                                        top_k)
    mesh = make_test_mesh(2, device=CPU, model=1)
    with use_mesh(mesh):
        assert data_shards() == 2
        r = TM.route(tp, torch.from_numpy(x), top_k)
        got, aux = TM.moe_ffn(tp, torch.from_numpy(x), top_k)
    assert data_shards() == 1
    assert r.capacity == 2 * max(1, int(t * top_k * 1.25 / e) // 2)
    _close(got, want, "moe output, two data shards")
    _close(aux, np.asarray(jaux), "aux", rtol=1e-5, atol_frac=0.0)
    assert not np.allclose(np_(got), np_(one), rtol=1e-3, atol=1e-3)


