"""GCN, GIN and GAT (twin of ``repro.models.gnn_extra``):

* **GCN**  [arXiv:1609.02907] — symmetric-normalised SpMM: Ã·X·W
* **GIN**  [arXiv:1810.00826] — sum aggregation + (1+ε) self + MLP
* **GAT**  [arXiv:1710.10903] — SDDMM edge scores → segment-softmax →
  SpMM

All on the primitives of ``models.message`` (fixed-order sums forward and
backward through ``pull_rows``); the edge softmax is ``seg_max`` for
stability, exp, and a ``seg_sum`` normalisation.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.gnn import GraphBatch, _init_mlp, _mlp, _tree
from repro_torch.models.message import degree, edge_gather, seg_max, seg_sum
from repro_torch.models.tree import ParamTree


# ---------------------------------------------------------------------------
# GCN
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn"
    n_layers: int = 2
    d_hidden: int = 64
    d_in: int = 1433
    n_classes: int = 7


def init_gcn(cfg: GCNConfig, generator: torch.Generator) -> ParamTree:
    dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return ParamTree([_init_mlp(generator, (a, b))[0]
                      for a, b in zip(dims[:-1], dims[1:])])


def gcn_forward(cfg: GCNConfig, params, g: GraphBatch) -> torch.Tensor:
    params = _tree(params)
    n = g.node_feats.shape[0]
    deg = degree(g.edge_dst, g.edge_mask, n) + 1.0      # +self loop
    dinv = torch.rsqrt(deg)
    h = g.node_feats
    for i, (w, b) in enumerate(params):
        hw = h @ w + b
        sent = edge_gather(hw * dinv[:, None], g.edge_src)
        sent = torch.where(g.edge_mask[:, None], sent, 0.0)
        agg = seg_sum(sent, g.edge_dst, n) * dinv[:, None]
        h = agg + hw * (dinv * dinv)[:, None]           # self loop term
        if i < len(params) - 1:
            h = torch.relu(h)
        h = torch.where(g.node_mask[:, None], h, 0.0)
    return h


# ---------------------------------------------------------------------------
# GIN
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str = "gin"
    n_layers: int = 3
    d_hidden: int = 64
    d_in: int = 16
    n_classes: int = 10


def init_gin(cfg: GINConfig, generator: torch.Generator) -> ParamTree:
    params = []
    d_prev = cfg.d_in
    for i in range(cfg.n_layers):
        d_out = cfg.d_hidden if i < cfg.n_layers - 1 else cfg.n_classes
        params.append(dict(
            mlp=_init_mlp(generator, (d_prev, cfg.d_hidden, d_out)),
            eps=torch.zeros((), device=generator.device)))
        d_prev = d_out
    return ParamTree(params)


def gin_forward(cfg: GINConfig, params, g: GraphBatch) -> torch.Tensor:
    params = _tree(params)
    n = g.node_feats.shape[0]
    h = g.node_feats
    for i, lp in enumerate(params):
        sent = edge_gather(h, g.edge_src)
        sent = torch.where(g.edge_mask[:, None], sent, 0.0)
        agg = seg_sum(sent, g.edge_dst, n)
        h = _mlp(lp["mlp"], (1.0 + lp["eps"]) * h + agg)
        if i < len(params) - 1:
            h = torch.relu(h)
        h = torch.where(g.node_mask[:, None], h, 0.0)
    return h


# ---------------------------------------------------------------------------
# GAT — SDDMM + segment-softmax
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat"
    n_layers: int = 2
    d_hidden: int = 64
    n_heads: int = 4
    d_in: int = 1433
    n_classes: int = 7


def init_gat(cfg: GATConfig, generator: torch.Generator) -> ParamTree:
    dev = generator.device
    params = []
    d_prev = cfg.d_in
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        d_out = cfg.n_classes if last else cfg.d_hidden
        params.append(dict(
            w=(torch.randn(d_prev, cfg.n_heads, d_out, generator=generator,
                           device=dev) * d_prev ** -0.5),
            a_src=torch.randn(cfg.n_heads, d_out, generator=generator,
                              device=dev) * 0.1,
            a_dst=torch.randn(cfg.n_heads, d_out, generator=generator,
                              device=dev) * 0.1))
        d_prev = d_out if last else d_out * cfg.n_heads
    return ParamTree(params)


def segment_softmax(scores: torch.Tensor, seg: torch.Tensor,
                    mask: torch.Tensor, n: int) -> torch.Tensor:
    """softmax over edges grouped by destination (numerically stable);
    a masked edge gets 0, a vertex of no live edge no mass."""
    s = torch.where(mask[:, None], scores, -1e30)
    mx = seg_max(s, seg, n)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    ex = torch.exp(s - edge_gather(mx, seg)) * mask[:, None]
    z = seg_sum(ex, seg, n)
    return ex / torch.clamp(edge_gather(z, seg), min=1e-30)


def gat_forward(cfg: GATConfig, params, g: GraphBatch) -> torch.Tensor:
    params = _tree(params)
    n = g.node_feats.shape[0]
    h = g.node_feats
    for i, lp in enumerate(params):
        last = i == len(params) - 1
        hw = torch.einsum("nd,dhk->nhk", h, lp["w"])       # [N, H, K]
        e_src = torch.einsum("nhk,hk->nh", hw, lp["a_src"])
        e_dst = torch.einsum("nhk,hk->nh", hw, lp["a_dst"])
        # SDDMM: score per edge (LeakyReLU(a_s·h_u + a_d·h_v))
        scores = F.leaky_relu(edge_gather(e_src, g.edge_src)
                              + edge_gather(e_dst, g.edge_dst), 0.2)
        attn = segment_softmax(scores, g.edge_dst, g.edge_mask, n)
        sent = edge_gather(hw, g.edge_src) * attn[..., None]
        agg = seg_sum(sent.reshape(sent.shape[0], -1), g.edge_dst,
                      n).reshape(n, cfg.n_heads, -1)
        h = torch.mean(agg, dim=1) if last else \
            F.elu(agg).reshape(n, -1)
        h = torch.where(g.node_mask[:, None], h, 0.0)
    return h
