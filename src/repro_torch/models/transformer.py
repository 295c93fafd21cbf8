"""Decoder-only LM for all five LM architectures (twin of
``repro.models.transformer``).

One parameterised stack covers:
  * gemma3-12b   — GQA(16/8), 5:1 local(1024):global attention, vocab 262144
  * qwen2.5-3b   — GQA(16/2), QKV bias, full attention
  * glm4-9b      — GQA(32/2), RoPE, full attention
  * qwen3-moe    — GQA(32/4) + 128-expert top-8 MoE FFN
  * arctic-480b  — GQA(56/8) + 128-expert top-2 MoE + dense-residual FFN

Layer parameters stay stacked ``[L, ...]`` (the reference's leaves, so
checkpoints and ``convert`` carry across leaf for leaf); a Python loop
takes each layer's views (``unbind``: in the backward one stack a leaf,
not a zero-filled copy a layer).  The reference's per-layer
``jax.checkpoint(nothing_saveable)`` is ``torch.utils.checkpoint``
around a layer, and around each ``lm_loss`` sequence chunk, so the
[B, S, V] logits are never held whole.  The embedding lookup is an
``edge_gather`` (``models.message``): its backward into the vocabulary's
rows is a fixed-order ``pull_rows`` sum, so a train step is the same bit
for bit from run to run on the card.

``decode_step`` writes the new K/V into the cache in place (one
``index_copy_`` a layer at the device-held length: no host read) and
returns the same cache tensors with the length advanced.

``LMConfig(counting=True)`` is the reference's counting mode, the
dry-run's FLOP count (``launch/dryrun.py``): the same math with the
layers unchecked (no ``torch.utils.checkpoint``, so no recompute),
attention in one chunk of the whole sequence, and ``lm_loss`` the cross
entropy of the full logits over every position (no remainder dropped).
The layer loop and ``decode_step`` are Python loops in both modes.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.message import edge_gather
from repro_torch.models.moe import MoEParams, init_moe, moe_ffn
from repro_torch.models.tree import init_device, randn, trainable, \
    tree_leaves, tree_unflatten

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # attention pattern: every `global_every`-th layer is global, others
    # local with `window`; None = all global (full causal)
    window: Optional[int] = None
    global_every: int = 1
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False   # arctic: dense MLP + MoE in parallel
    dtype: str = "bfloat16"
    # counting mode (the dry-run's FLOP count): layers unchecked, attention
    # in one chunk, the full-logit loss
    counting: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def _per_layer(self, experts: int) -> int:
        d, hd = self.d_model, self.hd
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        if self.is_moe:
            ffn = experts * 3 * d * self.moe_d_ff + d * self.n_experts
            if self.dense_residual:
                ffn += 3 * d * self.d_ff
        else:
            ffn = 3 * d * self.d_ff
        return attn + ffn + 2 * d

    def param_count(self) -> int:
        return self.n_layers * self._per_layer(self.n_experts) \
            + self.vocab * self.d_model + self.d_model

    def active_param_count(self) -> int:
        if not self.is_moe:
            return self.param_count()
        return self.n_layers * self._per_layer(self.top_k) \
            + self.vocab * self.d_model + self.d_model


class LayerParams(NamedTuple):
    """One decoder layer; every leaf stacked [L, ...]."""
    ln1: torch.Tensor          # [D]
    wq: torch.Tensor           # [D, H*hd]
    wk: torch.Tensor           # [D, KVH*hd]
    wv: torch.Tensor           # [D, KVH*hd]
    bq: torch.Tensor           # [H*hd]   (zeros when qkv_bias=False)
    bk: torch.Tensor
    bv: torch.Tensor
    wo: torch.Tensor           # [H*hd, D]
    ln2: torch.Tensor          # [D]
    w_gate: torch.Tensor       # [D, F] (dense FFN or arctic's residual;
    #                            0-size for an MoE without one)
    w_up: torch.Tensor
    w_down: torch.Tensor       # [F, D]
    moe: Optional[MoEParams]


class LMParams(NamedTuple):
    embed: torch.Tensor        # [V, D]
    layers: LayerParams        # stacked [L, ...]
    ln_f: torch.Tensor         # [D]


def init_lm(cfg: LMConfig, generator: torch.Generator,
            device=None) -> LMParams:
    """Random parameters by the reference's scheme (normal · scale, zero
    norms and biases), drawn from ``generator`` on ``device`` (by default
    its device; another stream than ``jax.random``: carry the reference's
    own with ``convert.lm_params_from_numpy``).  Stacked leaves are drawn
    a layer at a time, in f32, then cast.  On ``meta`` nothing is
    drawn."""
    dt, dev = cfg.torch_dtype, init_device(generator, device)
    d, hd, h, kvh = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    ldim = cfg.n_layers
    s = d ** -0.5

    def w(shape, scale):
        """A stacked leaf, drawn a layer at a time."""
        out = torch.empty(shape, dtype=dt, device=dev)
        for i in range(shape[0]):
            out[i] = randn(shape[1:], generator, dev) * scale
        return out

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    f = cfg.d_ff if (not cfg.is_moe or cfg.dense_residual) else 0
    moe = None
    if cfg.is_moe:
        e, fm = cfg.n_experts, cfg.moe_d_ff
        moe = MoEParams(
            torch.empty((ldim, d, e), dtype=F32, device=dev),
            *(torch.empty(shape, dtype=dt, device=dev)
              for shape in ((ldim, e, d, fm), (ldim, e, d, fm),
                            (ldim, e, fm, d))))
        for i in range(ldim):
            for dst, src in zip(moe, init_moe(generator, d, fm, e, dt,
                                              dev)):
                dst[i] = src
    layer = LayerParams(
        ln1=zeros(ldim, d),
        wq=w((ldim, d, h * hd), s), wk=w((ldim, d, kvh * hd), s),
        wv=w((ldim, d, kvh * hd), s),
        bq=zeros(ldim, h * hd), bk=zeros(ldim, kvh * hd),
        bv=zeros(ldim, kvh * hd),
        wo=w((ldim, h * hd, d), (h * hd) ** -0.5),
        ln2=zeros(ldim, d),
        w_gate=w((ldim, d, f), s), w_up=w((ldim, d, f), s),
        w_down=w((ldim, f, d), max(f, 1) ** -0.5),
        moe=moe)
    embed = randn((cfg.vocab, d), generator, dev).to(dt)
    return trainable(LMParams(embed=embed, layers=layer, ln_f=zeros(d)))


def unstack(layers: LayerParams) -> List[LayerParams]:
    """Each layer's views of the stacked leaves (one ``unbind`` a leaf)."""
    cols = [a.unbind(0) for a in tree_leaves(layers)]
    n = len(cols[0]) if cols else 0
    return [tree_unflatten(layers, [c[i] for c in cols]) for i in range(n)]


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------

def layer_locality(cfg: LMConfig) -> torch.Tensor:
    """i32[L] on the host: 1 for sliding-window layers (config-derived,
    not a parameter)."""
    if cfg.window is None:
        return torch.zeros((cfg.n_layers,), dtype=torch.int32)
    return (torch.arange(cfg.n_layers, dtype=torch.int32) % cfg.global_every
            != cfg.global_every - 1).to(torch.int32)


def _window(cfg: LMConfig, is_local: torch.Tensor, full: int):
    """The layer's window as the reference selects it: ``window`` on a
    local layer, ``full`` (past every key) on a global one; a host i32
    0-d tensor, or None for an all-global config."""
    if cfg.window is None:
        return None
    return torch.where(is_local.bool(), torch.tensor(cfg.window,
                                                     dtype=torch.int32),
                       torch.tensor(full, dtype=torch.int32))


def _attn_block(cfg: LMConfig, p: LayerParams, x, positions, is_local):
    b, s_len, d = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    xn = L.rms_norm(x, p.ln1)
    q = (xn @ p.wq + p.bq).reshape(b, s_len, h, hd)
    k = (xn @ p.wk + p.bk).reshape(b, s_len, kvh, hd)
    v = (xn @ p.wv + p.bv).reshape(b, s_len, kvh, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    # k, v keep their KVH heads: attention expands a chunk at a time
    out = L.chunked_causal_attention(
        q, k, v, window=_window(cfg, is_local, s_len + 1),
        chunk=s_len if cfg.counting else 512)
    out = out.reshape(b, s_len, h * hd)
    return x + out @ p.wo


def _ffn_block(cfg: LMConfig, p: LayerParams, x):
    b, s_len, d = x.shape
    xn = L.rms_norm(x, p.ln2)
    aux = torch.zeros((), dtype=F32, device=x.device)
    if cfg.is_moe:
        moe_out, aux = moe_ffn(p.moe, xn.reshape(-1, d), cfg.top_k)
        out = moe_out.reshape(b, s_len, d)
        if cfg.dense_residual:
            out = out + L.swiglu(xn, p.w_gate, p.w_up, p.w_down)
    else:
        out = L.swiglu(xn, p.w_gate, p.w_up, p.w_down)
    return x + out, aux


def _embed(cfg: LMConfig, params: LMParams, tokens: torch.Tensor):
    """params.embed[tokens] in the model dtype ([*tokens.shape, D])."""
    rows = edge_gather(params.embed, tokens.reshape(-1).to(torch.int32))
    return rows.reshape(tuple(tokens.shape) + (cfg.d_model,)).to(
        cfg.torch_dtype)


def backbone(cfg: LMConfig, params: LMParams, tokens: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: int32[B, S] -> (hidden [B, S, D], aux_loss f32[]); each
    layer checkpointed under autograd, but in counting mode."""
    b, s_len = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = torch.arange(s_len, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s_len)
    locality = layer_locality(cfg)

    def one_layer(x, lp, is_local):
        x = _attn_block(cfg, lp, x, positions, is_local)
        return _ffn_block(cfg, lp, x)

    auxes = []
    for i, lp in enumerate(unstack(params.layers)):
        if torch.is_grad_enabled() and not cfg.counting:
            x, aux = checkpoint(one_layer, x, lp, locality[i],
                                use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = one_layer(x, lp, locality[i])
        auxes.append(aux)
    return L.rms_norm(x, params.ln_f), torch.sum(torch.stack(auxes))


def logits_of(params: LMParams, x: torch.Tensor) -> torch.Tensor:
    """x [..., D] @ embed^T as f32 [..., V] (the tied output head)."""
    lead = x.shape[:-1]
    out = L.f32_product(x.reshape(-1, x.shape[-1]), params.embed.t())
    return out.reshape(tuple(lead) + (params.embed.shape[0],))


def forward(cfg: LMConfig, params: LMParams, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: int32[B, S] -> (logits f32[B, S, V], aux_loss)."""
    x, aux = backbone(cfg, params, tokens)
    return logits_of(params, x), aux


def _chunk_xent(params: LMParams, xch: torch.Tensor,
                lch: torch.Tensor) -> torch.Tensor:
    """Σ (logsumexp − gold logit) over one sequence chunk.  The gold logit
    is a gather (the reference's one-hot contraction gives the same value;
    its backward writes each row once)."""
    logits = logits_of(params, xch)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lch.long()[..., None])[..., 0]
    return torch.sum(logz - gold)


def lm_loss(cfg: LMConfig, params: LMParams, tokens: torch.Tensor,
            labels: torch.Tensor, *, seq_chunk: int = 512,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token cross entropy with seq-chunked logits: each chunk's
    [B, chunk, V] logits live only inside one checkpointed call.  As in
    the reference, ``s // seq_chunk`` chunks: a remainder is dropped.  In
    counting mode the full [B, S, V] logits over every position."""
    b, s_len = tokens.shape
    x, aux = backbone(cfg, params, tokens)
    if cfg.counting:
        total = _chunk_xent(params, x, labels)
        return total / (b * s_len) + aux_weight * aux
    seq_chunk = min(seq_chunk, s_len)
    n_chunks = s_len // seq_chunk
    total = torch.zeros((), dtype=F32, device=x.device)
    for i in range(n_chunks):
        sl = slice(i * seq_chunk, (i + 1) * seq_chunk)
        if torch.is_grad_enabled():
            part = checkpoint(_chunk_xent, params, x[:, sl], labels[:, sl],
                              use_reentrant=False, preserve_rng_state=False)
        else:
            part = _chunk_xent(params, x[:, sl], labels[:, sl])
        total = total + part
    return total / (b * n_chunks * seq_chunk) + aux_weight * aux


# ---------------------------------------------------------------------------
# decode (serving) — KV cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor            # [L, B, S_max, KVH, hd]
    v: torch.Tensor
    length: torch.Tensor       # i32[] on the cache's device


def init_cache(cfg: LMConfig, batch: int, max_len: int, length: int = 0,
               device: DeviceLike = None) -> KVCache:
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
                   torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
                   torch.tensor(length, dtype=torch.int32, device=device))


@torch.no_grad()
def decode_step(cfg: LMConfig, params: LMParams, cache: KVCache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, KVCache]:
    """One decode step.  tokens: int32[B, 1] -> (logits f32[B, 1, V],
    cache).  The new K/V are written into ``cache``'s tensors in place;
    the returned cache holds the same tensors and ``length + 1``.  The
    layers run unrolled in both modes."""
    b = tokens.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    smax = cache.k.shape[2]
    x = _embed(cfg, params, tokens)
    pos = cache.length.reshape(1, 1).expand(b, 1)
    at = cache.length.reshape(1).long()
    new_len = cache.length + 1
    locality = layer_locality(cfg)
    for i, lp in enumerate(unstack(params.layers)):
        xn = L.rms_norm(x, lp.ln1)
        q = (xn @ lp.wq + lp.bq).reshape(b, 1, h, hd)
        k = (xn @ lp.wk + lp.bk).reshape(b, 1, kvh, hd)
        v = (xn @ lp.wv + lp.bv).reshape(b, 1, kvh, hd)
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
        kc, vc = cache.k[i], cache.v[i]
        kc.index_copy_(1, at, k.to(kc.dtype))
        vc.index_copy_(1, at, v.to(vc.dtype))
        w = _window(cfg, locality[i], smax + 1)
        out = L.decode_attention(q, kc, vc, new_len,
                                 window=None if w is None else int(w))
        x = x + out.reshape(b, 1, h * hd) @ lp.wo
        x, _ = _ffn_block(cfg, lp, x)
    x = L.rms_norm(x, params.ln_f)
    return logits_of(params, x), KVCache(cache.k, cache.v, new_len)
