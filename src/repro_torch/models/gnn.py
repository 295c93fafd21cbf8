"""GNN zoo: GraphSAGE, PNA, NequIP-lite, GraphCast-style EPD (twin of
``repro.models.gnn``).

Message passing is a gather by edge src and a segment sum by edge dst.
Every sum goes through ``kernels.pull_contrib.pull_rows``: a CUDA kernel
on the card that cuts a segment's sorted slots into chunks, sums each
chunk in slot order and the chunks in chunk order, with no atomics, so a
forward and a train step are the same bit for bit from run to run.  It is
the function of the reference's one-shot ``segment_sum``, summed in
another f32 order.  The primitives with gradients (``seg_sum``,
``edge_gather``, ``seg_max``, ``neighbor_sum``) are in ``models.message``.

``sage_forward`` sorts the edge slots by dst once (``pull_order``, cached
with the edge tensors) and both layers sum each vertex's neighbour rows
over that order; with gradients on, the backward sums over the slots
sorted by src (``message.neighbor_sum``).  The plain version (on the
CPU) gathers the messages ``EDGE_CHUNK`` slots at a time
(``kernels.pull_contrib.ref``): at full width they would not fit at once
(48.6 M edge slots x 602 f32 = 117 GB on the smoke's graph).  In-degrees
are the order's segment lengths (``kernels.slot_count.segment_bounds``).

Parameters are ``models.tree.ParamTree``s laid out as the reference's
pytrees, trainable; the model functions take the tree (or the module).
The reference's ``constrain`` is a mesh sharding hint with no meaning on
one card, and is dropped.  NequIP's batch of molecules is one graph with
node offsets (``nequip_energies``) where the reference ``vmap``s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.graph.structure import cached_pull_order
from repro_torch.kernels.pull_contrib.pull_contrib import PullOrder, \
    pull_rows
from repro_torch.models import message
from repro_torch.models.message import degree, edge_gather, seg_max, \
    seg_min, seg_sum
from repro_torch.models.tree import ParamTree, init_device, randn


class GraphBatch(NamedTuple):
    node_feats: torch.Tensor   # f32[N, F]
    edge_src: torch.Tensor     # int32[E]
    edge_dst: torch.Tensor     # int32[E]
    edge_mask: torch.Tensor    # bool[E]
    node_mask: torch.Tensor    # bool[N]
    # molecular/equivariant extras
    positions: Optional[torch.Tensor] = None    # f32[N, 3]
    # graphcast extras: second node set + two bipartite edge sets
    mesh_feats: Optional[torch.Tensor] = None   # f32[M, Fm]
    g2m_src: Optional[torch.Tensor] = None
    g2m_dst: Optional[torch.Tensor] = None
    m2g_src: Optional[torch.Tensor] = None
    m2g_dst: Optional[torch.Tensor] = None


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
    (``neighbor_order``, built here if not given).  When ``feats`` needs a
    gradient the sum is ``message.neighbor_sum`` (the same forward, and a
    fixed-order backward)."""
    if torch.is_grad_enabled() and feats.requires_grad:
        return message.neighbor_sum(feats, src, dst, mask, n)
    if order is None:
        order = neighbor_order(src, dst, mask, n)
    return pull_rows(order, feats)


def _tree(params):
    return params.tree if isinstance(params, ParamTree) else params


def _mlp(params, x, act=torch.relu):
    for i, (w, b) in enumerate(params):
        x = x @ w + b
        if i < len(params) - 1:
            x = act(x)
    return x


def _init_mlp(generator: torch.Generator, dims,
              dev: torch.device = None) -> List[tuple]:
    """[(w f32[a, b] ~ N(0, 1/a), b zeros)] a layer (the reference's
    scheme, drawn from ``generator`` on ``dev``, by default its device)."""
    dev = init_device(generator, dev)
    return [(randn((a, b), generator, dev) * a ** -0.5,
             torch.zeros(b, device=dev))
            for a, b in zip(dims[:-1], dims[1:])]


def _max0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0.0)``, whose gradient at a tie is split in half
    (``torch.maximum`` splits it too; ``clamp`` would not)."""
    return torch.maximum(x, x.new_zeros(()))


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


class SAGE(ParamTree):
    """GraphSAGE parameters in the reference's layout: ``layers[i]
    ["w_self"]`` and ``layers[i]["w_neigh"]`` each hold a weight
    f32[d_in, d_out] and a bias f32[d_out] (``x @ w + b``), trainable.
    Serving calls ``sage_forward`` under ``torch.no_grad()``
    (``core.incremental_gnn``)."""

    def __init__(self, layers):
        """``layers``: one ``dict(w_self=(w, b), w_neigh=(w, b))`` of
        tensors per layer."""
        super().__init__([{k: tuple(lp[k]) for k in ("w_neigh", "w_self")}
                          for lp in layers])

    @property
    def layers(self):
        return self.tree


def init_sage(cfg: SAGEConfig, generator: torch.Generator,
              device=None) -> SAGE:
    """Random parameters by the reference's scheme (weights N(0, 1/d_in),
    biases 0), drawn from ``generator`` on ``device`` (by default its
    device; on ``meta`` nothing is drawn)."""
    dev = init_device(generator, device)
    layers, d_prev = [], cfg.d_in
    for i in range(cfg.n_layers):
        d_out = cfg.d_hidden if i < cfg.n_layers - 1 else cfg.n_classes
        layers.append({k: (
            randn((d_prev, d_out), generator, dev) * d_prev ** -0.5,
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
    layers = _tree(params)
    for i, lp in enumerate(layers):
        agg = neighbor_sum(h, g.edge_src, g.edge_dst, g.edge_mask, n,
                           order)
        # in place when no gradient flows (serving: d = 602 rows)
        mean = agg / deg if agg.requires_grad else agg.div_(deg)
        w_s, b_s = lp["w_self"]
        w_n, b_n = lp["w_neigh"]
        h = h @ w_s + mean @ w_n + b_s + b_n
        if i < len(layers) - 1:
            h = torch.relu(h)
        h = torch.where(g.node_mask[:, None], h, 0.0)
    return h


def sage_block_forward(cfg: SAGEConfig, params, feats_per_layer,
                       parents_per_layer, masks_per_layer) -> torch.Tensor:
    """Minibatch (sampled-block) forward for ``minibatch_lg``.

    feats_per_layer[l]: f32[B_l, F] raw features of level-l block nodes,
    innermost hop first (last entry = seeds).  parents_per_layer[i] maps
    rows of level i to rows of level i+1.  Layer j produces hidden states
    for every level but the deepest, consuming one level a layer; after L
    layers only the seeds' remain.  Each child row is one edge to its
    parent: the sum is ``seg_sum`` of the masked child rows by parent, the
    count the masked children a parent (``degree``)."""
    layers = _tree(params)
    reps = list(feats_per_layer)          # level L ... level 0 (seeds)
    for j, lp in enumerate(layers):
        w_s, b_s = lp["w_self"]
        w_n, b_n = lp["w_neigh"]
        new_reps = []
        for i in range(len(reps) - 1):
            child = reps[i]
            parent_self = reps[i + 1]
            parent_map = parents_per_layer[i + j]
            mask = masks_per_layer[i + j]
            nb_parents = parent_self.shape[0]
            sent = torch.where(mask[:, None], child, 0.0)
            agg = seg_sum(sent, parent_map, nb_parents)
            cnt = degree(parent_map, mask, nb_parents)
            mean = agg / cnt[:, None].clamp(min=1.0)
            h = parent_self @ w_s + mean @ w_n + b_s + b_n
            if j < len(layers) - 1:
                h = torch.relu(h)
            new_reps.append(h)
        reps = new_reps
    return reps[0]


# ===========================================================================
# PNA  [arXiv:2004.05718] — mean/max/min/std aggregators × id/amp/atten
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    d_in: int = 16
    n_classes: int = 10
    avg_degree: float = 4.0


def init_pna(cfg: PNAConfig, generator: torch.Generator,
             device=None) -> ParamTree:
    dev = init_device(generator, device)
    params = [dict(encode=_init_mlp(generator, (cfg.d_in, cfg.d_hidden),
                                    dev))]
    for _ in range(cfg.n_layers):
        params.append(dict(
            pre=_init_mlp(generator, (2 * cfg.d_hidden, cfg.d_hidden), dev),
            post=_init_mlp(generator, (13 * cfg.d_hidden, cfg.d_hidden),
                           dev)))
    params.append(dict(decode=_init_mlp(generator,
                                        (cfg.d_hidden, cfg.n_classes), dev)))
    return ParamTree(params)


def pna_forward(cfg: PNAConfig, params, g: GraphBatch) -> torch.Tensor:
    """f32[N, n_classes].  The std aggregator is the reference's
    ``sqrt(max(E[m²] - E[m]², 0))``: its gradient is infinite where the
    variance is exactly 0 (a vertex of one in-edge), so its parameter
    gradients are NaN there, in both packages."""
    params = _tree(params)
    n = g.node_feats.shape[0]
    h = _mlp(params[0]["encode"], g.node_feats)
    deg = degree(g.edge_dst, g.edge_mask, n)
    log_deg = torch.log1p(deg)[:, None]
    delta = math.log1p(cfg.avg_degree)
    live = g.edge_mask[:, None]
    for lp in params[1:-1]:
        msg_in = torch.cat([edge_gather(h, g.edge_src),
                            edge_gather(h, g.edge_dst)], dim=-1)
        msg = _mlp(lp["pre"], msg_in)
        msg = torch.where(live, msg, 0.0)
        s = seg_sum(msg, g.edge_dst, n)
        cnt = deg.clamp(min=1.0)[:, None]
        mean = s / cnt
        mx = torch.where(
            deg[:, None] > 0,
            seg_max(torch.where(live, msg, -1e30), g.edge_dst, n), 0.0)
        mn = torch.where(
            deg[:, None] > 0,
            seg_min(torch.where(live, msg, 1e30), g.edge_dst, n), 0.0)
        sq = seg_sum(torch.square(msg), g.edge_dst, n)
        std = torch.sqrt(_max0(sq / cnt - torch.square(mean)))
        scaled = []
        for a in (mean, mx, mn, std):
            scaled += [a, a * log_deg / delta,
                       a * delta / log_deg.clamp(min=1e-6)]
        hcat = torch.cat([h] + scaled, dim=-1)
        h = h + _mlp(lp["post"], hcat)
        h = torch.where(g.node_mask[:, None], h, 0.0)
    return _mlp(params[-1]["decode"], h)


# ===========================================================================
# NequIP-lite [arXiv:2101.03164] — E(3)-equivariant, l_max=2 restricted TP
# ===========================================================================
# Features per node: scalars s[N, C], vectors V[N, 3, C], rank-2 traceless
# T[N, 5, C].  Restricted tensor-product paths:
#   0⊗0→0, 0⊗1→1, 0⊗2→2  (radial-scalar gating of each irrep)
#   1⊗1→0 (dot), 1⊗1→1 (cross), 1⊗1→2 (traceless sym outer)

@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    channels: int = 32
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 4


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: max then min, each splitting a tie's gradient."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def _bessel_rbf(r, n_rbf, cutoff):
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    rc = _clip(r, 1e-6, cutoff)
    rb = math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * rc[..., None]
                                             / cutoff)
    rb = rb / rc[..., None]
    env = 0.5 * (torch.cos(math.pi * _clip(r, 0.0, cutoff) / cutoff) + 1.0)
    return rb * env[..., None]


def _sym_traceless(v):
    """v: [..., 3] -> 5 components of traceless symmetric outer product."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([x * y, y * z, x * z,
                        0.5 * (x * x - y * y),
                        (2 * z * z - x * x - y * y) / math.sqrt(12.0)], -1)


def _sym_traceless_pair(v, y):
    """v: [E,3,C], y: [E,3] -> traceless sym product [E,5,C]."""
    vx, vy, vz = v[:, 0], v[:, 1], v[:, 2]
    yx, yy, yz = y[:, 0:1], y[:, 1:2], y[:, 2:3]
    xy = 0.5 * (vx * yy + vy * yx)
    yz_ = 0.5 * (vy * yz + vz * yy)
    xz = 0.5 * (vx * yz + vz * yx)
    xx_yy = 0.5 * (vx * yx - vy * yy)
    zz = (2 * vz * yz - vx * yx - vy * yy) / math.sqrt(12.0)
    return torch.stack([xy, yz_, xz, xx_yy, zz], dim=1)


def init_nequip(cfg: NequIPConfig, generator: torch.Generator,
                device=None) -> ParamTree:
    c, dev = cfg.channels, init_device(generator, device)
    params = dict(
        embed=randn((cfg.n_species, c), generator, dev) * 0.5,
        layers=[dict(
            radial=_init_mlp(generator, (cfg.n_rbf, 32, 6 * c), dev),
            mix_s=_init_mlp(generator, (2 * c, c), dev),
            mix_v=randn((2 * c, c), generator, dev) * (2 * c) ** -0.5)
            for _ in range(cfg.n_layers)],
        readout=_init_mlp(generator, (c, 16, 1), dev))
    return ParamTree(params)


def _nequip_atoms(cfg: NequIPConfig, params, species, positions, edge_src,
                  edge_dst, edge_mask) -> torch.Tensor:
    """f32[N]: each atom's energy."""
    params = _tree(params)
    n = species.shape[0]
    c = cfg.channels
    dev = positions.device
    s = edge_gather(params["embed"], species)             # [N, C]
    v = torch.zeros(n, 3, c, device=dev)
    t = torch.zeros(n, 5, c, device=dev)
    rel = edge_gather(positions, edge_dst) - \
        edge_gather(positions, edge_src)                  # [E, 3]
    r = torch.linalg.vector_norm(rel + 1e-12, dim=-1)
    rhat = rel / torch.maximum(r[:, None], r.new_full((), 1e-6))
    rbf = _bessel_rbf(r, cfg.n_rbf, cfg.cutoff)           # [E, n_rbf]
    y1 = rhat                                             # [E, 3]  l=1 SH
    y2 = _sym_traceless(rhat)                             # [E, 5]  l=2 SH
    live = edge_mask.to(torch.float32)[:, None]
    for lp in params["layers"]:
        w = _mlp(lp["radial"], rbf) * live                # [E, 6C]
        w0, w1, w2, w11_0, w11_1, w11_2 = torch.chunk(w, 6, dim=-1)
        s_src = edge_gather(s, edge_src)                  # [E, C]
        v_src = edge_gather(v, edge_src)                  # [E, 3, C]
        # path 0⊗0→0, 0⊗1→1, 0⊗2→2: scalar × geometry
        m0 = w0 * s_src
        m1 = w1[:, None, :] * s_src[:, None, :] * y1[:, :, None]
        m2 = w2[:, None, :] * s_src[:, None, :] * y2[:, :, None]
        # paths 1⊗1→{0,1,2}: vector features × edge direction
        dot = torch.einsum("eic,ei->ec", v_src, y1)
        m0 = m0 + w11_0 * dot
        vt = v_src.transpose(1, 2)
        cross = torch.linalg.cross(vt, y1[:, None, :].expand_as(vt),
                                   dim=-1).transpose(1, 2)
        m1 = m1 + w11_1[:, None, :] * cross
        outer = _sym_traceless_pair(v_src, y1)
        m2 = m2 + w11_2[:, None, :] * outer
        agg_s = seg_sum(m0, edge_dst, n)
        agg_v = seg_sum(m1, edge_dst, n)
        agg_t = seg_sum(m2, edge_dst, n)
        s = _mlp(lp["mix_s"], torch.cat([s, agg_s], -1))
        v = torch.einsum("nic,cd->nid", torch.cat([v, agg_v], -1),
                         lp["mix_v"])
        t = t + agg_t
        # invariant gate keeps equivariance: scale v/t by σ(s)
        gate = torch.sigmoid(s)[:, None, :]
        v = v * gate
        t = t * gate
    return _mlp(params["readout"], s)[:, 0]


def nequip_forward(cfg: NequIPConfig, params, species: torch.Tensor,
                   positions: torch.Tensor, edge_src, edge_dst,
                   edge_mask) -> torch.Tensor:
    """Energy of one graph.  species: int32[N]; positions: f32[N, 3]."""
    return torch.sum(_nequip_atoms(cfg, params, species, positions,
                                   edge_src, edge_dst, edge_mask))


def molecule_graph(species, positions, edge_src, edge_dst, edge_mask):
    """A batch of B molecules of A atoms ([B, A], [B, A, 3], [B, E] x 3)
    as one graph of B·A atoms: molecule b's atoms are rows [b·A, (b+1)·A)
    and its edge indices shifted by b·A (int32)."""
    nb, na = species.shape
    off = (torch.arange(nb, dtype=torch.int32, device=edge_src.device)
           * na)[:, None]
    return (species.reshape(-1), positions.reshape(nb * na, 3),
            (edge_src + off).reshape(-1), (edge_dst + off).reshape(-1),
            edge_mask.reshape(-1))


def nequip_energies(cfg: NequIPConfig, params, species, positions,
                    edge_src, edge_dst, edge_mask) -> torch.Tensor:
    """f32[B]: the energy of each molecule of a batch (``molecule_graph``
    layout; the reference ``vmap``s ``nequip_forward`` over them)."""
    nb, na = species.shape
    atoms = _nequip_atoms(cfg, params, *molecule_graph(
        species, positions, edge_src, edge_dst, edge_mask))
    return atoms.reshape(nb, na).sum(dim=-1)


# ===========================================================================
# GraphCast-style encoder-processor-decoder [arXiv:2212.12794]
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    name: str = "graphcast"
    n_layers: int = 16
    d_hidden: int = 512
    n_vars: int = 227
    mesh_refinement: int = 6


def init_graphcast(cfg: GraphCastConfig, generator: torch.Generator,
                   device=None) -> ParamTree:
    d, dev = cfg.d_hidden, init_device(generator, device)
    params = dict(
        grid_enc=_init_mlp(generator, (cfg.n_vars, d), dev),
        g2m=_init_mlp(generator, (2 * d, d), dev),
        m2g=_init_mlp(generator, (2 * d, d), dev),
        grid_dec=_init_mlp(generator, (2 * d, d, cfg.n_vars), dev),
        mesh_enc=_init_mlp(generator, (3, d), dev),
        proc=[dict(edge=_init_mlp(generator, (2 * d, d), dev),
                   node=_init_mlp(generator, (2 * d, d), dev))
              for _ in range(cfg.n_layers)])
    return ParamTree(params)


def graphcast_forward(cfg: GraphCastConfig, params,
                      g: GraphBatch) -> torch.Tensor:
    """grid feats [G, n_vars] + mesh feats [M, 3] -> next-step grid
    vars."""
    params = _tree(params)
    n_grid = g.node_feats.shape[0]
    n_mesh = g.mesh_feats.shape[0]
    hg = _mlp(params["grid_enc"], g.node_feats)
    hm = _mlp(params["mesh_enc"], g.mesh_feats)
    # encoder: grid -> mesh
    msg = _mlp(params["g2m"], torch.cat(
        [edge_gather(hg, g.g2m_src), edge_gather(hm, g.g2m_dst)], -1))
    hm = hm + seg_sum(msg, g.g2m_dst, n_mesh)
    # processor: interaction-network rounds on the mesh graph
    live = g.edge_mask[:, None]
    for lp in params["proc"]:
        em = _mlp(lp["edge"], torch.cat(
            [edge_gather(hm, g.edge_src), edge_gather(hm, g.edge_dst)], -1))
        em = torch.where(live, em, 0.0)
        agg = seg_sum(em, g.edge_dst, n_mesh)
        hm = hm + _mlp(lp["node"], torch.cat([hm, agg], -1))
    # decoder: mesh -> grid
    msg = _mlp(params["m2g"], torch.cat(
        [edge_gather(hm, g.m2g_src), edge_gather(hg, g.m2g_dst)], -1))
    hg_upd = hg + seg_sum(msg, g.m2g_dst, n_grid)
    return _mlp(params["grid_dec"], torch.cat([hg_upd, hg], -1))
