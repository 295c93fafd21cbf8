"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch
(twin of ``repro.models.moe``).

Each (token, k) pair takes a position in its expert's capacity from its
rank in a stable sort by expert; pairs past the capacity are dropped.
Dispatch is an inverse-permutation gather: the token ids are scattered
(ints, each kept slot written once) into an [E·C] table whose empty slots
name a zero sentinel row, and the rows are gathered by it.  The experts
run as batched products over E, and the results come back by a gather of
each kept slot and a sum by token.  As in the reference, the pairs are
ranked within each data shard of the active mesh (``dist.constraints.
data_shards()``, 1 without a mesh), each shard with its share of the
capacity, so a mesh drops other pairs than one device does.

Every float sum of rows, forward and backward, has a fixed order
(``models.message``): the combine's sum by token is ``seg_sum`` (a
``pull_rows`` over the pairs sorted by token), the dispatch gather is
``edge_gather`` (its backward a ``pull_rows`` sum by token), and the
combine's gather reads each kept slot once, so its backward writes each
slot once (``_kept_rows``).  A train step is then the same bit for bit
from run to run on the card.

Supports qwen3-moe-30b-a3b (128 experts, top-8) and arctic-480b (128
experts, top-2, plus a dense residual MLP, in ``models.transformer``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.constraints import data_shards
from repro_torch.models.message import edge_gather, seg_sum
from repro_torch.models.tree import init_device, randn

F32 = torch.float32


class MoEParams(NamedTuple):
    w_router: torch.Tensor    # [D, E] f32
    w_gate: torch.Tensor      # [E, D, F]
    w_up: torch.Tensor        # [E, D, F]
    w_down: torch.Tensor      # [E, F, D]


class Routing(NamedTuple):
    """A layer's routing: ``slot`` each (token, k) pair's row of the
    [E·C] expert buffer (E·C where dropped), ``keep`` whether it was kept,
    ``gate`` its renormalised router weight, ``tok`` its token."""
    gate: torch.Tensor        # f32[T·k]
    slot: torch.Tensor        # int64[T·k]
    keep: torch.Tensor        # bool[T·k]
    tok: torch.Tensor         # int32[T·k]
    capacity: int
    aux: torch.Tensor         # f32[]


def init_moe(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, dtype=torch.bfloat16,
             device=None) -> MoEParams:
    """Random parameters by the reference's scheme (normal · fan-in^-1/2),
    drawn from ``generator`` on ``device`` (by default its device; on
    ``meta`` nothing is drawn)."""
    dev = init_device(generator, device)

    def w(shape, scale, dt):
        return (randn(shape, generator, dev) * scale).to(dt)
    s_in, s_ff = d_model ** -0.5, d_ff ** -0.5
    return MoEParams(
        w_router=w((d_model, n_experts), s_in, F32),
        w_gate=w((n_experts, d_model, d_ff), s_in, dtype),
        w_up=w((n_experts, d_model, d_ff), s_in, dtype),
        w_down=w((n_experts, d_ff, d_model), s_ff, dtype))


def route(params: MoEParams, x: torch.Tensor, top_k: int,
          capacity_factor: float = 1.25) -> Routing:
    """Top-k routing, the load-balancing loss and each pair's slot.  The
    pairs are ranked within each of ``data_shards()`` rows (one without a
    mesh), each row with its own share of the capacity, as the reference
    ranks them within each data shard; ``capacity`` is the rows' total."""
    t = x.shape[0]
    e = params.w_router.shape[1]
    c = max(1, int(t * top_k * capacity_factor / e))   # from the shapes
    dev = x.device
    logits = x.to(F32) @ params.w_router
    probs = torch.softmax(logits, dim=-1)
    gate, expert = torch.topk(probs, top_k, dim=-1)      # [T, k]
    gate = gate / torch.sum(gate, -1, keepdim=True)
    # load-balancing auxiliary loss (Switch-style); the one-hot count as a
    # comparison, exact in f32 (no scatter, no size read)
    me = torch.mean(probs, dim=0)
    hits = expert[..., None] == torch.arange(e, device=dev)
    ce = torch.mean(torch.sum(hits.to(F32), dim=1), dim=0)
    aux = e * torch.sum(me * ce)
    # rank of each pair within its expert and data shard: a stable sort
    # by expert within each shard's row of pairs
    flat = expert.reshape(-1)
    tk = flat.shape[0]
    ds = data_shards()
    if tk % ds != 0:
        ds = 1
    tk_l, c_local = tk // ds, max(1, c // ds)
    sorted_e, order = torch.sort(flat.reshape(ds, tk_l), dim=1, stable=True)
    start = torch.searchsorted(
        sorted_e, torch.arange(e, device=dev).expand(ds, e).contiguous())
    pos_sorted = torch.arange(tk_l, device=dev)[None, :] \
        - torch.gather(start, 1, sorted_e)
    pos = torch.empty_like(pos_sorted).scatter_(1, order,
                                                pos_sorted).reshape(-1)
    shard = torch.arange(ds, device=dev).repeat_interleave(tk_l)
    keep = pos < c_local
    c = c_local * ds
    slot = torch.where(keep, flat * c + shard * c_local + pos,
                       torch.full_like(pos, e * c))
    tok = torch.arange(t, dtype=torch.int32, device=dev).repeat_interleave(
        top_k)
    return Routing(gate.reshape(-1), slot, keep, tok, c, aux)


class _KeptRows(torch.autograd.Function):
    """rows[slot] where ``keep``, else 0: each kept slot is read by one
    pair, so the backward writes each row of the gradient once (dropped
    pairs write zeros to the sentinel row, which is cut off)."""

    @staticmethod
    def forward(ctx, rows, slot, keep):
        ctx.save_for_backward(slot, keep)
        ctx.n = rows.shape[0]
        pad = torch.cat([rows, rows.new_zeros(1, rows.shape[1])])
        return torch.where(keep[:, None], pad.index_select(0, slot), 0.0)

    @staticmethod
    def backward(ctx, g):
        slot, keep = ctx.saved_tensors
        out = g.new_zeros(ctx.n + 1, g.shape[1])
        out.index_copy_(0, slot, torch.where(keep[:, None], g, 0.0))
        return out[:ctx.n], None, None


def moe_ffn(params: MoEParams, x: torch.Tensor, top_k: int,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [T, D] flat tokens -> ([T, D], aux_loss)."""
    t, d = x.shape
    e = params.w_router.shape[1]
    r = route(params, x, top_k, capacity_factor)
    c = r.capacity
    # dispatch: the token ids into their slots (the sentinel t where a
    # slot is empty), then the rows gathered
    inv = torch.full((e * c + 1,), t, dtype=torch.int32, device=x.device)
    inv = inv.scatter_(0, r.slot, r.tok)[: e * c]
    x_pad = torch.cat([x, x.new_zeros(1, d)])
    buf = edge_gather(x_pad, inv).reshape(e, c, d)
    # the experts, as batched products over E
    g = torch.bmm(buf, params.w_gate)
    u = torch.bmm(buf, params.w_up)
    y = torch.bmm(F.silu(g) * u, params.w_down).reshape(e * c, d)
    # combine: each pair's kept row, weighted, summed by token
    gathered = _KeptRows.apply(y, r.slot, r.keep)
    weighted = gathered.to(F32) * r.gate[:, None]
    out = seg_sum(weighted, r.tok, t)
    return out.to(x.dtype), r.aux
