"""Transformer building blocks: RMSNorm, RoPE, GQA attention, SwiGLU (twin
of ``repro.models.layers``).

Attention is chunked as in the reference (an online max and denominator
over kv chunks, ``NEG_INF`` for masked logits, the S×S scores never held
whole), with the loop turned around: the kv chunks run in order, each
against every query it can reach at once, so a layer is ~S/chunk steps of
a few launches each, not (S/chunk)² blocks.  The queries a step reaches
are a sliding range (the carry): a query joins when its first visible kv
chunk comes and leaves, finished, after the chunk that holds it.  Blocks
the reference computes and then masks wholly (future keys, keys past a
sliding window) are skipped; in the reference they change nothing (a
fully masked chunk before a query's first visible one is erased by the
first correction factor, ``exp(-1e30 - m) = 0``; one after adds exactly
0), so each query gets the reference's sums.  Its softmax max is taken
without a gradient: the shift cancels in the softmax, as in the
reference's gradient, up to rounding.

GQA keeps one cache head per group of query heads: attention expands a
kv chunk (not the whole sequence) to the query heads, and decode groups
the query heads over the cache's heads, so a 32k cache is never copied.

Products the reference asks in f32 from bf16 operands
(``preferred_element_type=jnp.float32``: attention logits, ``pv``, the
LM's logits) keep an f32 result (``f32_product``): on the card cuBLAS's
bf16 product with an f32 output (``torch.bmm(..., out_dtype=)``), its
backward two bf16 products (on ``meta`` too, so the dry-run counts the
card's program); on the CPU the operands in f32.  Elsewhere a
product in the parameter dtype gives that dtype, as the reference's
einsums do.  Attention is no Pallas kernel in the reference, so these are
plain torch (cuBLAS products), not kernels of this repository.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32
NEG_INF = -1e30

# ---------------------------------------------------------------------------
# products with an f32 result
# ---------------------------------------------------------------------------


class _ProductF32(torch.autograd.Function):
    """a @ b (bf16 or f16 operands, 2-D or 3-D) with an f32 result, on the
    card; the backward's products are in the operands' dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a, b, out_dtype=F32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = g @ b.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        gb = a.transpose(-1, -2) @ g if ctx.needs_input_grad[1] else None
        return ga, gb


def f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as f32 (``a``: [M, K] or [N, M, K]; ``b`` to match)."""
    if a.dtype == F32 and b.dtype == F32:
        return a @ b
    if a.is_cuda or a.is_meta:              # meta: the dry-run counts it
        return _ProductF32.apply(a, b)
    return a.to(F32) @ b.to(F32)


# ---------------------------------------------------------------------------
# norms / positional
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(F32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(F32))).to(dtype)


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, H, D]; positions: int32[..., S]."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)              # [D/2]
    angles = positions[..., None].to(F32) * freqs       # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]               # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _expand_kv(k: torch.Tensor, n_q_heads: int) -> torch.Tensor:
    """[B,S,KVH,D] -> [B,S,QH,D] by group repeat (GQA)."""
    return torch.repeat_interleave(k, n_q_heads // k.shape[2], dim=2)


def _scale(d: int) -> float:
    """The reference's ``1 / sqrt(d)`` in f32 (its sqrt in f64, then f32)."""
    return float(np.float32(1.0) / np.float32(math.sqrt(d)))


def _host_window(window) -> Optional[int]:
    """``window`` as a host int (None: no window).  A window tensor is read
    once: the transformer hands its per-layer window over as a CPU tensor,
    which costs no device sync."""
    return None if window is None else int(window)


def _heads(t: torch.Tensor, rep: int) -> torch.Tensor:
    """[B, KVH, C, D] -> [B·KVH·rep, C, D]: a kv chunk for each query
    head (head h reads kv head h // rep)."""
    b, kvh, c, d = t.shape
    if rep > 1:
        t = t[:, :, None].expand(b, kvh, rep, c, d)
    return t.reshape(b * kvh * rep, c, d)


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, window=None,
                             chunk: int = 512) -> torch.Tensor:
    """Flash-style causal attention, O(S·chunk) memory a head.

    q: [B, S, H, D]; k, v: [B, S, KVH, D] with KVH dividing H (H: already
    expanded, as the reference takes them).  ``window``: sliding window
    for local layers: an int, an i32 0-d tensor (the per-layer window,
    as the reference's traced scalar), or None (full causal).  Whole
    blocks past the window are skipped.
    """
    b, s, h, d = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    scale = _scale(d)
    chunk = min(chunk, s)
    win = _host_window(window)
    dev = q.device
    grad = torch.is_grad_enabled()
    qh = q.transpose(1, 2).contiguous()         # [B, H, S, D]
    kh = k.transpose(1, 2).contiguous()         # [B, KVH, S, D]
    vh = v.transpose(1, 2).contiguous()
    outs = []
    m = l = o = None                            # the carry: queries [lo, hi)
    hi = 0
    for k0 in range(0, s, chunk):
        k1 = min(s, k0 + chunk)
        top = s if win is None else min(s, k1 - 1 + win)
        if top > hi:                            # queries reaching this chunk
            n = top - hi
            fresh = (torch.full((b, h, n), NEG_INF, dtype=F32, device=dev),
                     torch.zeros((b, h, n), dtype=F32, device=dev),
                     torch.zeros((b, h, n, d), dtype=F32, device=dev))
            if m is None:
                m, l, o = fresh
            else:
                m, l, o = (torch.cat([m, fresh[0]], 2),
                           torch.cat([l, fresh[1]], 2),
                           torch.cat([o, fresh[2]], 2))
            hi = top
        r = hi - k0
        qs = qh[:, :, k0:hi].reshape(b * h, r, d)
        logits = f32_product(qs, _heads(kh[:, :, k0:k1], rep).transpose(1, 2))
        logits = logits.mul_(scale).view(b, h, r, k1 - k0)
        qpos = torch.arange(k0, hi, device=dev)
        kpos = torch.arange(k0, k1, device=dev)
        diag = min(k1, hi) - k0                 # rows that see future keys
        logits[:, :, :diag].masked_fill_(
            qpos[:diag, None] < kpos[None, :], NEG_INF)
        if win is not None and win < r:         # rows past the window
            logits[:, :, win:].masked_fill_(
                (qpos[win:, None] - kpos[None, :]) >= win, NEG_INF)
        with torch.no_grad():
            m_new = torch.maximum(m, logits.amax(-1))
            corr = torch.exp(m - m_new)
        p = logits.sub_(m_new[..., None]).exp_()
        pv = f32_product(p.to(v.dtype).view(b * h, r, k1 - k0),
                         _heads(vh[:, :, k0:k1], rep)).view(b, h, r, d)
        if grad:
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + pv
        else:
            l = l.mul_(corr).add_(p.sum(-1))
            o = o.mul_(corr[..., None]).add_(pv)
        m = m_new
        done = k1 - k0                          # queries [k0, k1) finished
        outs.append((o[:, :, :done] / torch.clamp(
            l[:, :, :done], min=1e-30)[..., None]).to(q.dtype))
        m, l, o = m[:, :, done:], l[:, :, done:], o[:, :, done:]
    return torch.cat(outs, 2).transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len,
                     window=None) -> torch.Tensor:
    """Single-token decode over a KV cache.

    q: [B, 1, H, D]; k_cache/v_cache: [B, S_max, KVH, D]; cache_len: i32
    0-d tensor (or int).  The query heads are grouped over the cache's
    heads (one product per cache head, reading the cache in place), not
    the cache expanded to the query heads.
    """
    b, smax, kvh, d = k_cache.shape
    h = q.shape[2]
    rep = h // kvh
    scale = _scale(d)
    qg = q.reshape(b, kvh, rep, d)
    kpos = torch.arange(smax, device=q.device)
    mask = kpos < cache_len
    if window is not None:
        mask &= kpos >= (cache_len - window)
    outs = []
    for g in range(kvh):
        logits = f32_product(qg[:, g], k_cache[:, :, g].transpose(1, 2))
        logits = torch.where(mask, logits * scale, NEG_INF)  # [B, rep, S]
        mx = torch.amax(logits, -1, keepdim=True)
        p = torch.exp(logits - mx)
        den = torch.sum(p, -1, keepdim=True)
        outs.append(f32_product((p / den).to(v_cache.dtype),
                                v_cache[:, :, g]))          # [B, rep, D]
    return torch.stack(outs, 1).reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g) * u) @ w_down
