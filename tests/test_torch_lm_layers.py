"""Port parity: the LM's layers (``repro_torch.models.layers``, ``moe``)
against ``repro.models.layers`` / ``repro.models.moe`` on the same seeded
NumPy inputs, in f32: rtol 1e-5 / atol 1e-6 (sums in another order:
chunked attention's loop, ``pull_rows``' chunks); then the twins of
``tests/test_layers_properties.py``'s LM cases on the port alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401
from repro.models import layers as JL
from repro.models import moe as JM

from repro_torch.models import layers as L
from repro_torch.models import moe as M
from test_torch_common import np_

RTOL, ATOL = 1e-5, 1e-6


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _naive_attention(q, k, v, window=None):
    """The reference test's naive softmax attention, in torch."""
    b, s, h, d = q.shape
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(d)
    qpos = torch.arange(s)[:, None]
    kpos = torch.arange(s)[None, :]
    mask = qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    logits = torch.where(mask[None, None], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 3, 5, 16), _rand(rng, 16)
    want = JL.rms_norm(jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_allclose(np_(L.rms_norm(_t(x), _t(scale))),
                               np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_apply_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 9, 3, 8)
    pos = np.arange(9, dtype=np.int32)[None].repeat(2, 0) + 5
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = L.apply_rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("s,chunk,window,kvh", [
    (16, 4, None, 3), (32, 8, 8, 3), (33, 8, None, 1), (16, 16, 4, 3),
    (40, 8, 3, 1), (40, 8, 20, 3), (37, 5, 12, 1), (12, 16, None, 3)])
def test_chunked_attention_matches_reference(s, chunk, window, kvh):
    """Every (s, chunk, window): windows shorter than a chunk, longer,
    a ragged last chunk, a chunk past s; kv given with 3 heads (expanded,
    as the reference takes them) or 1 (GQA: the port expands a chunk at a
    time)."""
    rng = np.random.default_rng(s + chunk)
    q = _rand(rng, 2, s, 3, 8)
    k, v = _rand(rng, 2, s, kvh, 8), _rand(rng, 2, s, kvh, 8)
    kx, vx = (np.repeat(a, 3 // kvh, axis=2) for a in (k, v))
    want = JL.chunked_causal_attention(jnp.asarray(q), jnp.asarray(kx),
                                       jnp.asarray(vx), window=window,
                                       chunk=chunk)
    got = L.chunked_causal_attention(_t(q), _t(k), _t(v), window=window,
                                     chunk=chunk)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_chunked_attention_window_tensor():
    """The per-layer window as an i32 tensor (the reference's traced
    scalar) equals the reference's; a window past every key is full
    causal attention."""
    rng = np.random.default_rng(2)
    q, k, v = (_rand(rng, 1, 24, 2, 4) for _ in range(3))
    for w in (4, 25):
        want = JL.chunked_causal_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            window=jnp.int32(w), chunk=8)
        got = L.chunked_causal_attention(
            _t(q), _t(k), _t(v), window=torch.tensor(w, dtype=torch.int32),
            chunk=8)
        np.testing.assert_allclose(np_(got), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_chunked_attention_gradients_match_reference():
    """Gradients through the chunked loop (the max taken without one:
    its terms cancel) against the reference's ``jax.grad``."""
    rng = np.random.default_rng(3)
    q, k, v = (_rand(rng, 2, 20, 2, 4) for _ in range(3))
    w = _rand(rng, 2, 20, 2, 4)

    def jloss(q, k, v):
        out = JL.chunked_causal_attention(q, k, v, window=7, chunk=8)
        return jnp.sum(out * w)
    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = L.chunked_causal_attention(tq, tk, tv, window=7, chunk=8)
    got = torch.autograd.grad(torch.sum(out * _t(w)), (tq, tk, tv))
    for a, b in zip(got, want):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_matches_reference(window):
    """The port groups 4 query heads over 2 cache heads; the reference
    expands the cache."""
    rng = np.random.default_rng(4)
    q = _rand(rng, 2, 1, 4, 8)
    kc, vc = _rand(rng, 2, 16, 2, 8), _rand(rng, 2, 16, 2, 8)
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(11, jnp.int32),
                               window=window)
    got = L.decode_attention(_t(q), _t(kc), _t(vc),
                             torch.tensor(11, dtype=torch.int32),
                             window=window)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_swiglu_matches_reference():
    rng = np.random.default_rng(5)
    # weights at the models' scale, normal · fan-in^-1/2
    x, wg, wu, wd = (_rand(rng, 3, 4, 8),
                     _rand(rng, 8, 12) * np.float32(8 ** -0.5),
                     _rand(rng, 8, 12) * np.float32(8 ** -0.5),
                     _rand(rng, 12, 8) * np.float32(12 ** -0.5))
    want = JL.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd)))
    np.testing.assert_allclose(np_(L.swiglu(*(_t(a) for a in
                                              (x, wg, wu, wd)))),
                               np.asarray(want), rtol=RTOL, atol=ATOL)


def _moe_pair(seed, t, d, f, e):
    jp = JM.init_moe(jax.random.PRNGKey(seed), d, f, e, dtype=jnp.float32)
    tp = M.MoEParams(*(_t(np.asarray(a)) for a in jp))
    x = _rand(np.random.default_rng(seed), t, d)
    return jp, tp, x


def _reference_kept(jp, x, top_k, cf):
    """The reference's kept (token, k) pairs: its top-k experts, each
    pair kept when its stable rank within its expert is under C."""
    e = jp.w_router.shape[1]
    t = x.shape[0]
    probs = jax.nn.softmax(jnp.asarray(x) @ jp.w_router, axis=-1)
    _, idx = jax.lax.top_k(probs, top_k)
    flat = np.asarray(idx).reshape(-1)
    c = max(1, int(t * top_k * cf / e))
    rank = np.empty_like(flat)
    for ex in range(e):
        where = np.nonzero(flat == ex)[0]
        rank[where] = np.arange(len(where))
    return rank < c, flat


@pytest.mark.parametrize("t,top_k,cf", [(64, 2, 1.25), (64, 2, 0.1),
                                        (64, 2, 8.0), (37, 3, 1.25)])
def test_moe_ffn_matches_reference(t, top_k, cf):
    """Output, aux loss and the kept set; the routing first."""
    jp, tp, x = _moe_pair(t + top_k, t, 16, 24, 8)
    keep, flat = _reference_kept(jp, x, top_k, cf)
    r = M.route(tp, _t(x), top_k, cf)
    assert np.array_equal(np_(r.slot) // r.capacity * r.keep.numpy()
                          + (~r.keep.numpy()) * 8,
                          np.where(keep, flat, 8))
    assert np.array_equal(np_(r.keep), keep)
    want, jaux = JM.moe_ffn(jp, jnp.asarray(x), top_k, cf)
    got, aux = M.moe_ffn(tp, _t(x), top_k, cf)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)


def test_moe_ffn_gradients_match_reference():
    jp, tp, x = _moe_pair(7, 48, 16, 24, 8)
    w = _rand(np.random.default_rng(8), 48, 16)

    def jloss(p, x):
        out, aux = JM.moe_ffn(p, x, 2)
        return jnp.sum(out * w) + aux
    jg = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = [a.requires_grad_() for a in tp]
    tx = _t(x).requires_grad_()
    out, aux = M.moe_ffn(M.MoEParams(*leaves), tx, 2)
    tg = torch.autograd.grad(torch.sum(out * _t(w)) + aux, leaves + [tx])
    for a, b in zip(tg, list(jg[0]) + [jg[1]]):
        np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-5 * np.abs(np.asarray(b)).max())


# ---------------------------------------------------------------------------
# twins of tests/test_layers_properties.py's LM cases, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk,window", [(16, 4, None), (32, 8, 8),
                                            (33, 8, None), (16, 16, 4)])
def test_chunked_attention_matches_naive(s, chunk, window):
    rng = np.random.default_rng(0)
    q, k, v = (_t(_rand(rng, 2, s, 3, 8)) for _ in range(3))
    out = L.chunked_causal_attention(q, k, v, window=window, chunk=chunk)
    np.testing.assert_allclose(np_(out), np_(_naive_attention(q, k, v,
                                                              window)),
                               rtol=2e-4, atol=2e-5)


def test_decode_attention_matches_naive_last_position():
    rng = np.random.default_rng(2)
    s = 12
    q_all = _t(_rand(rng, 2, s, 4, 8))
    k_all, v_all = _t(_rand(rng, 2, s, 2, 8)), _t(_rand(rng, 2, s, 2, 8))
    ref = _naive_attention(q_all, L._expand_kv(k_all, 4),
                           L._expand_kv(v_all, 4))[:, -1:]
    pad = torch.zeros(2, 4, 2, 8)
    out = L.decode_attention(q_all[:, -1:], torch.cat([k_all, pad], 1),
                             torch.cat([v_all, pad], 1),
                             torch.tensor(s, dtype=torch.int32))
    np.testing.assert_allclose(np_(out), np_(ref), rtol=2e-4, atol=2e-5)


def test_rope_preserves_norm_and_relative_phase():
    rng = np.random.default_rng(3)
    x = _t(_rand(rng, 1, 6, 2, 8))
    pos = torch.arange(6, dtype=torch.int32)[None]
    out = L.apply_rope(x, pos)
    np.testing.assert_allclose(np_(out.norm(dim=-1)), np_(x.norm(dim=-1)),
                               rtol=1e-5)
    q, k = L.apply_rope(x, pos), L.apply_rope(x, pos + 7)
    np.testing.assert_allclose(np_((q * q).sum(-1)), np_((k * k).sum(-1)),
                               rtol=1e-4)


def test_moe_capacity_drops_overflow():
    _, tp, x = _moe_pair(0, 32, 8, 16, 4)
    small, _ = M.moe_ffn(tp, _t(x), top_k=2, capacity_factor=0.1)
    big, _ = M.moe_ffn(tp, _t(x), top_k=2, capacity_factor=8.0)
    assert float(small.abs().sum()) < float(big.abs().sum())


def test_moe_dispatch_conservation():
    _, tp, x = _moe_pair(1, 64, 16, 32, 8)
    out, aux = M.moe_ffn(tp, _t(x), top_k=2, capacity_factor=4.0)
    assert out.shape == (64, 16) and torch.isfinite(out).all()
    assert float(aux) > 0


def test_rms_norm_scale_and_dtype():
    x = _t(np.random.default_rng(0).standard_normal((4, 16))).to(
        torch.bfloat16)
    out = L.rms_norm(x, torch.zeros(16, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16
    rms = out.float().square().mean(-1).sqrt()
    np.testing.assert_allclose(np_(rms), 1.0, rtol=0.1)


def test_bf16_products_keep_an_f32_result():
    """``f32_product`` of bf16 operands is f32 (the reference's
    ``preferred_element_type``), equal to the product of the operands in
    f32; attention on bf16 inputs returns bf16."""
    rng = np.random.default_rng(6)
    a = _t(_rand(rng, 3, 5, 8)).to(torch.bfloat16)
    b = _t(_rand(rng, 3, 8, 4)).to(torch.bfloat16)
    out = L.f32_product(a, b)
    assert out.dtype == torch.float32
    assert torch.equal(out, a.float() @ b.float())
    q = _t(_rand(rng, 1, 10, 2, 8)).to(torch.bfloat16)
    assert L.chunked_causal_attention(q, q, q, chunk=4).dtype == \
        torch.bfloat16
