"""Message-passing primitives with gradients, summed in a fixed order.

The reference passes messages with ``x[idx]`` and ``jax.ops.segment_sum``
/ ``segment_max`` (``repro.models.gnn``).  In PyTorch on the card the
backward of ``x[idx]`` adds with float atomics, in an order that changes
from run to run; here every sum, forward and backward, goes through
``kernels.pull_contrib.pull_rows`` (the CUDA kernel on the card, its plain
version on the CPU), which sums rows over a sorted slot order in chunks of
``ROW_CHUNK`` slots, then the chunks in order, so a train step is the same
bit for bit from run to run:

  ``seg_sum(vals, idx, n)``   forward: ``pull_rows`` over the slots sorted
                              by ``idx``, gathering slot rows; backward:
                              a gather of the output's gradient.
  ``edge_gather(x, idx)``     forward: a gather; backward: ``seg_sum`` of
                              the slots' gradients by ``idx``.
  ``seg_max`` / ``seg_min``   ``scatter_reduce`` amax, exact in any order;
                              the backward splits a segment's gradient
                              evenly among its ties, as JAX's does (the
                              tie counts are a ``seg_sum``).
  ``neighbor_sum``            the gather by src and the sum by dst in one
                              ``pull_rows`` each way (GraphSAGE's full
                              graph): no [E, D] message tensor.

Rows of a 16-bit type (bf16 LM parameters and activations) are summed in
f32 and the sums rounded to that type (``_sum_rows``), where the reference
adds a bf16 scatter in bf16.

A slot order holds **every** slot whose index is in [0, n), masked or not:
the reference sums masked slots too (as zeros, ``where``), and a masked
slot's gradient is not always zero (GAT's ``mx[seg]``).  Orders are built
once an index tensor and cached with it (``segment_ops.plan.cached``);
``ORDER_BUILDS`` counts the builds.  In a slot order every "source" is one
slot, so ``pull_rows``' hot set (sources ranked by live slots) means
nothing there: those calls pass ``hot_bytes=0``.
"""
from __future__ import annotations

import collections
from typing import Tuple

import torch

from repro_torch.graph.structure import cached_pull_order
from repro_torch.kernels.pull_contrib.pull_contrib import PullOrder, \
    pull_rows, sorted_slots
from repro_torch.kernels.segment_ops.plan import cached

__all__ = ["ORDER_BUILDS", "degree", "edge_gather", "neighbor_sum",
           "seg_max", "seg_min", "seg_sum", "slot_order"]

ORDER_BUILDS: collections.Counter = collections.Counter()


def slot_order(idx: torch.Tensor, n: int) -> Tuple[PullOrder, torch.Tensor]:
    """(order, in_range bool[E]): the slots of ``idx`` (int32[E]) sorted
    stably by index, each slot with an index in [0, n) live and its own
    slot number as its "source"; built at the first call on this tensor
    and ``n``."""
    def build():
        ORDER_BUILDS["slot_order"] += 1
        ok = (idx >= 0) & (idx < n)
        ptr, perm, keys = sorted_slots(idx.to(torch.int32), ok, n)
        return PullOrder(ptr, perm.to(torch.int32), keys), ok
    return cached(idx, ("slot_order", n), build)


def _sum_rows(order: PullOrder, rows: torch.Tensor) -> torch.Tensor:
    """``pull_rows`` of [E, D] slot rows (any float shape flattened).
    ``pull_rows`` sums f32 (f64 rows stay f64 on the CPU): rows of another
    type (bf16) are summed in f32 and the sums rounded to their type."""
    if rows.dtype in (torch.float32, torch.float64):
        return pull_rows(order, rows.contiguous(), hot_bytes=0)
    return pull_rows(order, rows.to(torch.float32).contiguous(),
                     hot_bytes=0).to(rows.dtype)


class _SegSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, idx, n):
        order, ok = slot_order(idx, n)
        ctx.save_for_backward(idx, ok)
        ctx.n = n
        return _sum_rows(order, vals)

    @staticmethod
    def backward(ctx, g):
        idx, ok = ctx.saved_tensors
        gi = g.index_select(0, idx.long().clamp(0, ctx.n - 1))
        return torch.where(ok[:, None], gi, 0.0), None, None


class _EdgeGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[0]
        return x.index_select(0, idx.long())

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        order, _ = slot_order(idx, ctx.n)
        return _sum_rows(order, g), None


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], -1)


def seg_sum(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """out[v] = Σ vals[e] over the slots e with idx[e] == v, [n, ...] in
    ``vals``' dtype (slots out of [0, n) are dropped, as
    ``jax.ops.segment_sum`` drops them; bf16 rows are summed in f32)."""
    out = _SegSum.apply(_flat(vals), idx, n)
    return out.reshape((n,) + tuple(vals.shape[1:]))


def edge_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] for int32 ``idx`` in [0, len(x)): rows to slots."""
    out = _EdgeGather.apply(_flat(x), idx)
    return out.reshape((idx.shape[0],) + tuple(x.shape[1:]))


class _SegMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, idx, n):
        order, ok = slot_order(idx, n)
        i = idx.long().clamp(0, n - 1)[:, None].expand_as(vals)
        v = torch.where(ok[:, None], vals, float("-inf"))
        out = torch.full((n, vals.shape[1]), float("-inf"),
                         dtype=vals.dtype, device=vals.device)
        out.scatter_reduce_(0, i, v, "amax", include_self=True)
        ctx.save_for_backward(idx, ok, vals, out)
        ctx.n = n
        return out

    @staticmethod
    def backward(ctx, g):
        idx, ok, vals, out = ctx.saved_tensors
        order, _ = slot_order(idx, ctx.n)
        i = idx.long().clamp(0, ctx.n - 1)
        tie = (vals == out.index_select(0, i)) & ok[:, None]
        # the ties of each segment, counted exactly in a fixed order
        count = _sum_rows(order, tie.to(vals.dtype))
        share = g / count.clamp(min=1.0)
        return torch.where(tie, share.index_select(0, i), 0.0), None, None


def seg_max(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """out[v] = max vals[e] over the slots with idx[e] == v; -inf for an
    empty segment (``jax.ops.segment_max``)."""
    out = _SegMax.apply(_flat(vals), idx, n)
    return out.reshape((n,) + tuple(vals.shape[1:]))


def seg_min(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """The reference's ``-segment_max(-vals)``."""
    return -seg_max(-vals, idx, n)


def degree(dst: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
    """f32[n]: each vertex's masked in-edges, from the segment bounds of
    the masked slots sorted by dst (exact below 2**24), cached with the
    tensors."""
    def build():
        ORDER_BUILDS["degree"] += 1
        ptr = sorted_slots(dst.to(torch.int32), mask, n)[0]
        return (ptr[1:] - ptr[:-1]).to(torch.float32)
    return cached((dst, mask), ("degree", n), build)


class _NeighborSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, dst, mask, n):
        ctx.save_for_backward(src, dst, mask)
        ctx.n_src = x.shape[0]
        return pull_rows(cached_pull_order(src, dst, mask, n),
                         x.contiguous())

    @staticmethod
    def backward(ctx, g):
        src, dst, mask = ctx.saved_tensors
        # the transposed sum: the masked slots sorted by src, gathering
        # the gradient rows of their dst
        back = cached_pull_order(dst, src, mask, ctx.n_src)
        return pull_rows(back, g.contiguous()), None, None, None, None


def neighbor_sum(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                 mask: torch.Tensor, n: int) -> torch.Tensor:
    """out[v] = Σ x[src(e)] over the masked edges e with dst(e) == v, the
    reference's ``seg_sum(where(mask, x[src], 0), dst, n)``: a ``pull_rows``
    over the slots sorted by dst, and in the backward one over the slots
    sorted by src (both orders cached with the edge tensors)."""
    return _NeighborSum.apply(x, src, dst, mask, n)
