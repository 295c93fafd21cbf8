"""GraphSAGE on the segment-op substrate (twin of the GraphSAGE part of
``repro.models.gnn``).

Message passing is a gather by edge src and a segment sum by edge dst
(``index_add_``).  At full width the gathered messages do not fit the card
(48.6 M edge slots x 602 f32 = 117 GB on the smoke's graph), so
``neighbor_sum`` takes the slots ``EDGE_CHUNK`` at a time: the same
function as the reference's one-shot ``segment_sum``, summed in another
f32 order.

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

# edge slots gathered at once: 5 GB of f32 messages at D = 602, under 2**31
# elements (torch's 32-bit index math)
EDGE_CHUNK = 1 << 21


class GraphBatch(NamedTuple):
    node_feats: torch.Tensor   # f32[N, F]
    edge_src: torch.Tensor     # int32[E]
    edge_dst: torch.Tensor     # int32[E]
    edge_mask: torch.Tensor    # bool[E]
    node_mask: torch.Tensor    # bool[N]


def _seg_sum(vals, idx, n):
    out = vals.new_zeros((n,) + tuple(vals.shape[1:]))
    return out.index_add_(0, idx.long(), vals)


def _gather_send(feats, src, mask):
    """Messages ``feats[src]``, zero where ``mask`` is false."""
    return feats[src.long()].masked_fill_(~mask[:, None], 0.0)


def _degree(dst, mask, n):
    return _seg_sum(mask.to(torch.float32), dst, n)


def neighbor_sum(feats, src, dst, mask, n: int) -> torch.Tensor:
    """``_seg_sum(_gather_send(feats, src, mask), dst, n)``, ``EDGE_CHUNK``
    edge slots at a time: out[v] = Σ_{mask e: dst(e)=v} feats[src(e)]."""
    out = feats.new_zeros(n, feats.shape[1])
    for s in range(0, src.shape[0], EDGE_CHUNK):
        e = slice(s, s + EDGE_CHUNK)
        out.index_add_(0, dst[e].long(), _gather_send(feats, src[e], mask[e]))
    return out


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
    deg = _degree(g.edge_dst, g.edge_mask, n)[:, None].clamp_(min=1.0)
    for i, lp in enumerate(params.layers):
        mean = neighbor_sum(h, g.edge_src, g.edge_dst, g.edge_mask,
                            n).div_(deg)
        w_s, b_s = lp["w_self"]
        w_n, b_n = lp["w_neigh"]
        h = h @ w_s + mean @ w_n + b_s + b_n
        if i < len(params.layers) - 1:
            h = torch.relu(h)
        h = torch.where(g.node_mask[:, None], h, 0.0)
    return h
