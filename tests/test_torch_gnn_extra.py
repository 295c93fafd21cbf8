"""Port parity: GCN, GIN and GAT (``repro_torch.models.gnn_extra``) and the
message primitives with gradients (``repro_torch.models.message``)
against ``repro``.

  * the primitives: ``torch.autograd.gradcheck`` in f64 (the plain
    versions keep f64 rows), and values and gradients equal to the
    reference's ``_seg_sum`` / ``_edge_gather`` / ``_seg_max`` under
    ``jax.grad`` (ties of a segment max split evenly, as JAX splits
    them); slots out of range dropped; one order an index tensor;
  * ``segment_softmax`` on segments with and without live edges;
  * GCN, GIN and GAT forward within rtol 1e-5 / atol 1e-6·max and every
    parameter gradient within rtol 1e-4 / atol 1e-5·max|g|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.models import gnn as jgnn
from repro.models import gnn_extra as jx

from repro_torch import convert
from repro_torch.models import gnn as tgnn
from repro_torch.models import gnn_extra as tx
from repro_torch.models import message
from repro_torch.train.steps import value_and_grad
from test_torch_common import np_

N, E, D = 23, 97, 5


def _close(got, want, what, rtol=1e-4, atol_frac=1e-5):
    got, want = np_(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * scale + 1e-30, err_msg=what)


def _idx(rng, n, e, lo=0):
    return rng.integers(lo, n, e).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_primitives_gradcheck_f64(seed):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(_idx(rng, N, E))
    vals = torch.from_numpy(rng.standard_normal((E, D))).requires_grad_()
    x = torch.from_numpy(rng.standard_normal((N, D))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda v: message.seg_sum(v, idx, N), (vals,))
    assert torch.autograd.gradcheck(
        lambda a: message.edge_gather(a, idx), (x,))
    # distinct values: the max is differentiable away from ties
    uniq = torch.from_numpy(rng.permutation(E * D).reshape(E, D)
                            .astype(np.float64)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda v: message.seg_max(v, idx, N).clamp(min=-1e3), (uniq,))
    src = torch.from_numpy(_idx(rng, N, E))
    mask = torch.from_numpy(rng.random(E) < 0.7)
    assert torch.autograd.gradcheck(
        lambda a: message.neighbor_sum(a, src, idx, mask, N), (x,))


@pytest.mark.parametrize("seed", [0, 3])
def test_primitives_match_jax_grad(seed):
    rng = np.random.default_rng(seed)
    idx = _idx(rng, N, E)
    idx[:4] = [N, N + 3, -1, N]                # out of range: dropped
    vals = rng.standard_normal((E, D)).astype(np.float32)
    vals[10:14] = vals[9]                      # ties within a segment
    idx[9:14] = idx[9]
    x = rng.standard_normal((N, D)).astype(np.float32)
    ct = rng.standard_normal((N, D)).astype(np.float32)
    cte = rng.standard_normal((E, D)).astype(np.float32)
    ok = np.clip(idx, 0, N - 1)
    ti = torch.from_numpy(idx)
    for name, jf, tf, arg, cot in (
            ("seg_sum", lambda v: jgnn._seg_sum(v, jnp.asarray(idx), N),
             lambda v: message.seg_sum(v, ti, N), vals, ct),
            ("seg_max", lambda v: jgnn._seg_max(v, jnp.asarray(idx), N),
             lambda v: message.seg_max(v, ti, N), vals, ct),
            ("seg_min", lambda v: jgnn._seg_min(v, jnp.asarray(idx), N),
             lambda v: message.seg_min(v, ti, N), vals, ct),
            ("edge_gather", lambda a: jgnn._edge_gather(a, jnp.asarray(ok)),
             lambda a: message.edge_gather(a, torch.from_numpy(ok)), x,
             cte)):
        jout, vjp = jax.vjp(jf, jnp.asarray(arg))
        (jg,) = vjp(jnp.asarray(cot))
        t = torch.from_numpy(arg).requires_grad_()
        tout = tf(t)
        (tg,) = torch.autograd.grad(tout, t, torch.from_numpy(cot))
        fin = np.isfinite(np.asarray(jout))
        assert np.array_equal(np.isfinite(np_(tout.detach())), fin), name
        _close(np_(tout.detach())[fin], np.asarray(jout)[fin], name,
               rtol=1e-6, atol_frac=1e-6)
        _close(tg, jg, name + " grad", rtol=1e-6, atol_frac=1e-6)


def test_orders_built_once_per_index_tensor():
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(_idx(rng, N, E))
    x = torch.randn(N, D, requires_grad=True)
    before = message.ORDER_BUILDS["slot_order"]
    for _ in range(3):
        y = message.seg_sum(message.edge_gather(x, idx), idx, N)
        y.sum().backward()
    assert message.ORDER_BUILDS["slot_order"] - before == 1


def test_segment_softmax_with_and_without_live_edges():
    rng = np.random.default_rng(5)
    seg = _idx(rng, N, E)
    seg[seg == 3] = 4                      # vertex 3: no slot at all
    mask = rng.random(E) < 0.6
    mask[seg == 5] = False                 # vertex 5: masked slots only
    assert (seg == 5).any()
    scores = rng.standard_normal((E, 2)).astype(np.float32)
    want = np.asarray(jx.segment_softmax(jnp.asarray(scores),
                                         jnp.asarray(seg),
                                         jnp.asarray(mask), N))
    s = torch.from_numpy(scores).requires_grad_()
    got = tx.segment_softmax(s, torch.from_numpy(seg),
                             torch.from_numpy(mask), N)
    _close(got.detach(), want, "softmax", rtol=1e-6, atol_frac=1e-7)
    assert np.all(np_(got.detach())[~mask] == 0)
    sums = np.zeros((N, 2))
    np.add.at(sums, seg[mask], np_(got.detach())[mask])
    live = np.isin(np.arange(N), seg[mask])
    np.testing.assert_allclose(sums[live], 1.0, rtol=1e-5)
    cot = rng.standard_normal((E, 2)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jx.segment_softmax(
        x, jnp.asarray(seg), jnp.asarray(mask), N), jnp.asarray(scores))
    (jg,) = vjp(jnp.asarray(cot))
    (tg,) = torch.autograd.grad(got, s, torch.from_numpy(cot))
    _close(tg, jg, "softmax grad", rtol=1e-5, atol_frac=1e-6)


def _graph(seed, n=40, e=200, d_in=12):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, d_in)).astype(np.float32)
    src, dst = _idx(rng, n, e), _idx(rng, n, e)
    emask, nmask = rng.random(e) < 0.8, rng.random(n) < 0.9
    jg = jgnn.GraphBatch(*(jnp.asarray(a) for a in
                           (feats, src, dst, emask, nmask)))
    tg = tgnn.GraphBatch(*(torch.from_numpy(a) for a in
                           (feats, src, dst, emask, nmask)))
    return jg, tg


MODELS = {
    "gcn": (jx.GCNConfig, jx.init_gcn, jx.gcn_forward, tx.gcn_forward),
    "gin": (jx.GINConfig, jx.init_gin, jx.gin_forward, tx.gin_forward),
    "gat": (jx.GATConfig, jx.init_gat, jx.gat_forward, tx.gat_forward),
}


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("seed", [0, 1])
def test_extra_models_match_reference(model, seed):
    jcfg_t, jinit, jfwd, tfwd = MODELS[model]
    jcfg = dataclasses.replace(jcfg_t(), d_in=12, d_hidden=8, n_classes=3)
    tcfg = getattr(tx, jcfg_t.__name__)(**dataclasses.asdict(jcfg))
    jg, tg = _graph(seed)
    jp = jinit(jcfg, jax.random.PRNGKey(seed))
    tp = convert.gnn_params_from_numpy(
        model, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    assert len(tp.leaves()) == len(jax.tree_util.tree_leaves(jp))
    want = np.asarray(jfwd(jcfg, jp, jg))
    got = tfwd(tcfg, tp, tg)
    _close(got.detach(), want, f"{model} forward", rtol=1e-5,
           atol_frac=1e-6)
    w = np.random.default_rng(9).standard_normal(want.shape).astype(
        np.float32)
    jgrad = jax.grad(lambda p: jnp.sum(jfwd(jcfg, p, jg) * w))(jp)
    _, tgrad = value_and_grad(
        lambda p, _: torch.sum(tfwd(tcfg, p, tg) * torch.from_numpy(w)),
        tp, None)
    for i, (a, b) in enumerate(zip(tgrad,
                                   jax.tree_util.tree_leaves(jgrad))):
        _close(a, b, f"{model} grad leaf {i}")


@pytest.mark.parametrize("model", sorted(MODELS))
def test_extra_models_init_layout(model):
    """The port's own init draws the reference's shapes, in its flatten
    order, trainable."""
    jcfg_t, jinit, _, _ = MODELS[model]
    jp = jinit(jcfg_t(), jax.random.PRNGKey(0))
    init = getattr(tx, f"init_{model}")
    tp = init(getattr(tx, jcfg_t.__name__)(),
              torch.Generator().manual_seed(0))
    assert [tuple(p.shape) for p in tp.leaves()] == \
        [tuple(np.shape(x)) for x in jax.tree_util.tree_leaves(jp)]
    assert all(p.requires_grad for p in tp.leaves())
