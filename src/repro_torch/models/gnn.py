"""GraphSAGE on the segment-op substrate (twin of the GraphSAGE part of
``repro.models.gnn``).

Message passing is a gather by edge src and a segment sum by edge dst.
``sage_forward`` sorts the edge slots by dst once (``pull_order``, cached
with the edge tensors) and both layers sum each vertex's neighbour rows
over that order with ``kernels.pull_contrib.pull_rows``: a CUDA kernel on
the card that cuts a
vertex's slots into chunks, sums each chunk in slot order and the chunks
in chunk order, with no atomics, so the forward is the same bit for bit
from run to run.  It is the function of the reference's one-shot
``segment_sum``, summed in another f32 order.  The plain version (on the
CPU) gathers the messages ``EDGE_CHUNK`` slots at a time
(``kernels.pull_contrib.ref``): at full width they would not fit at once
(48.6 M edge slots x 602 f32 = 117 GB on the smoke's graph).  In-degrees
are the order's segment lengths (``kernels.slot_count.segment_bounds``).

Not ported yet (ROADMAP): PNA, NequIP, GraphCast, the minibatch
``sage_block_forward`` and ``GraphBatch``'s fields for them.  The
reference's ``constrain`` is a mesh sharding hint with no meaning on one
card, and is dropped.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.graph.structure import cached_pull_order
from repro_torch.kernels.pull_contrib.pull_contrib import PullOrder, \
    pull_rows


class GraphBatch(NamedTuple):
    node_feats: torch.Tensor   # f32[N, F]
    edge_src: torch.Tensor     # int32[E]
    edge_dst: torch.Tensor     # int32[E]
    edge_mask: torch.Tensor    # bool[E]
    node_mask: torch.Tensor    # bool[N]


def neighbor_order(src, dst, mask, n: int) -> PullOrder:
    """The edge slots sorted by dst (masked ones last), with each vertex's
    in-edges as its segment: one sort, cached with the edge tensors
    (``graph.structure.cached_pull_order``), so a forward's layers, the
    graph's frontier pushes and a later forward on the same tensors share
    it."""
    return cached_pull_order(src, dst, mask, n)


def neighbor_sum(feats, src, dst, mask, n: int,
                 order: Optional[PullOrder] = None) -> torch.Tensor:
    """out[v] = Σ_{mask e: dst(e)=v} feats[src(e)] over ``order``
    (``neighbor_order``, built here if not given)."""
    if order is None:
        order = neighbor_order(src, dst, mask, n)
    return pull_rows(order, feats)


# ===========================================================================
# GraphSAGE  [arXiv:1706.02216]  — 2 layers, d=128, mean aggregator
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    name: str = "graphsage-reddit"
    n_layers: int = 2
    d_hidden: int = 128
    d_in: int = 602
    n_classes: int = 41
    fanouts: Tuple[int, ...] = (25, 10)


class SAGE(nn.Module):
    """GraphSAGE parameters in the reference's layout: ``layers[i]
    ["w_self"]`` and ``layers[i]["w_neigh"]`` each hold a weight
    f32[d_in, d_out] and a bias f32[d_out] (``x @ w + b``).  The port
    serves embeddings, so the parameters need no gradient."""

    def __init__(self, layers):
        """``layers``: one ``dict(w_self=(w, b), w_neigh=(w, b))`` of
        tensors per layer."""
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleDict({k: nn.ParameterList(
                [nn.Parameter(t, requires_grad=False) for t in lp[k]])
                for k in ("w_self", "w_neigh")})
            for lp in layers)


def init_sage(cfg: SAGEConfig, generator: torch.Generator) -> SAGE:
    """Random parameters by the reference's scheme (weights N(0, 1/d_in),
    biases 0), drawn from ``generator`` on its device."""
    dev = generator.device
    layers, d_prev = [], cfg.d_in
    for i in range(cfg.n_layers):
        d_out = cfg.d_hidden if i < cfg.n_layers - 1 else cfg.n_classes
        layers.append({k: (
            torch.randn(d_prev, d_out, generator=generator, device=dev)
            * d_prev ** -0.5,
            torch.zeros(d_out, device=dev)) for k in ("w_self", "w_neigh")})
        d_prev = d_out
    return SAGE(layers)


def sage_forward(cfg: SAGEConfig, params: SAGE, g: GraphBatch,
                 affected: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-graph forward: f32[N, n_classes].

    ``affected`` is accepted and ignored, as in the reference, whose
    docstring says it routes aggregation through the gated kernel but
    whose body never reads it.  The gated aggregation is
    ``kernels.segment_ops.ops.aggregate_features``."""
    n = g.node_feats.shape[0]
    h = g.node_feats
    order = neighbor_order(g.edge_src, g.edge_dst, g.edge_mask, n)
    # integer in-degrees, exact in f32 below 2**24
    deg = (order.ptr[1:] - order.ptr[:-1]).to(torch.float32)[:, None] \
        .clamp_(min=1.0)
    for i, lp in enumerate(params.layers):
        mean = neighbor_sum(h, g.edge_src, g.edge_dst, g.edge_mask, n,
                            order).div_(deg)
        w_s, b_s = lp["w_self"]
        w_n, b_n = lp["w_neigh"]
        h = h @ w_s + mean @ w_n + b_s + b_n
        if i < len(params.layers) - 1:
            h = torch.relu(h)
        h = torch.where(g.node_mask[:, None], h, 0.0)
    return h
