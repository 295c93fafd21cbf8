"""Inputs for every LM, GNN and recsys (architecture × shape) cell (twin
of ``repro.train.inputs``).

``concrete=True`` draws bounded random arrays from NumPy's
``default_rng(seed)`` in the reference's order, so one seed gives the
reference's inputs bit for bit, and puts them on ``device``.
``concrete=False`` returns tensors on the ``meta`` device (shape and dtype
only, no allocation: the reference's ``ShapeDtypeStruct``s).
``abstract_state`` and ``abstract_cache`` build a cell's parameters,
optimizer state and KV cache on ``meta`` (the reference's
``jax.eval_shape``): nothing is drawn or allocated, so the full configs
build with no card (the dry-run, ``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.common import ArchSpec, ShapeCell
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.gnn import (PNAConfig, SAGEConfig, init_graphcast,
                                    init_nequip, init_pna, init_sage)
from repro_torch.models.recsys import init_deepfm
from repro_torch.optim.adamw import init_adamw

F32 = torch.float32
I32 = torch.int32
BOOL = torch.bool


class _Builder:
    """Emits either meta tensors or bounded random tensors."""

    def __init__(self, concrete: bool, seed: int = 0,
                 device: DeviceLike = None):
        self.concrete = concrete
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device) if concrete else \
            torch.device("meta")

    def _put(self, a: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(device=self.device,
                                                  dtype=dtype)

    def _meta(self, shape, dtype) -> torch.Tensor:
        return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                           device="meta")

    def ints(self, shape, bound):
        if not self.concrete:
            return self._meta(shape, I32)
        return self._put(self.rng.integers(0, max(bound, 1), size=shape)
                         .astype(np.int32), I32)

    def floats(self, shape, dtype=F32):
        if not self.concrete:
            return self._meta(shape, dtype)
        return self._put(self.rng.standard_normal(shape).astype(np.float32),
                         dtype)

    def bools(self, shape, frac=1.0):
        if not self.concrete:
            return self._meta(shape, BOOL)
        return self._put(self.rng.random(shape) < frac, BOOL)


# ---------------------------------------------------------------------------
# per-cell effective model config (shape-dependent dims)
# ---------------------------------------------------------------------------

def effective_config(spec: ArchSpec, cell: ShapeCell, smoke: bool = False):
    cfg = spec.smoke_config if smoke else spec.config
    d = cell.dims
    if spec.family == "gnn" and cell.kind == "gnn_full":
        if isinstance(cfg, (SAGEConfig, PNAConfig)):
            cfg = dataclasses.replace(cfg, d_in=d["d_feat"] if not smoke
                                      else cfg.d_in)
    return cfg


def _gnn_cell_dims(spec: ArchSpec, cell: ShapeCell, smoke: bool
                   ) -> Dict[str, int]:
    """Resolve (N, E, ...) for a gnn cell, reduced when smoke."""
    d = dict(cell.dims)
    if cell.kind == "gnn_minibatch":
        b, f0, f1 = d["batch_nodes"], d["fanout0"], d["fanout1"]
        if smoke:
            b, f0, f1 = 8, 3, 2
        d.update(batch_nodes=b, fanout0=f0, fanout1=f1)
        # subgraph view for non-sampling archs
        d["n_sub_nodes"] = b * (1 + f0 + f0 * f1)
        d["n_sub_edges"] = b * f0 + b * f0 * f1
    elif cell.kind == "gnn_molecule":
        if smoke:
            d.update(batch=4)
    else:
        if smoke:
            d.update(n_nodes=64, n_edges=256, d_feat=d.get("d_feat", 16))
    return d


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def gnn_inputs(spec: ArchSpec, cell: ShapeCell, *, concrete=False,
               smoke=False, seed=0, device: DeviceLike = None
               ) -> Dict[str, Any]:
    """Node/edge buffers are padded to a 512 multiple (8 for smoke), as
    the reference pads them for its mesh; the models mask padded slots
    via edge_mask/node_mask."""
    b = _Builder(concrete, seed, device)
    cfg = effective_config(spec, cell, smoke)
    d = _gnn_cell_dims(spec, cell, smoke)
    arch = spec.arch_id
    mult = 8 if smoke else 512

    if arch == "graphsage-reddit" and cell.kind == "gnn_minibatch":
        bn, f0, f1 = d["batch_nodes"], d["fanout0"], d["fanout1"]
        b2, b1 = bn * f0 * f1, bn * f0
        din = cfg.d_in
        return dict(
            blocks_feats=[b.floats((b2, din)), b.floats((b1, din)),
                          b.floats((bn, din))],
            blocks_parent=[b.ints((b2,), b1), b.ints((b1,), bn)],
            blocks_mask=[b.bools((b2,)), b.bools((b1,))],
            labels=b.ints((bn,), cfg.n_classes))

    if cell.kind == "gnn_minibatch":
        n, e = d["n_sub_nodes"], d["n_sub_edges"]
        dfeat = getattr(cfg, "d_in", 16)
    elif cell.kind == "gnn_molecule":
        n = d["n_nodes"] * d["batch"]
        e = d["n_edges"] * d["batch"]
        dfeat = getattr(cfg, "d_in", 16)
    else:
        n, e = d["n_nodes"], d["n_edges"]
        dfeat = getattr(cfg, "d_in", d.get("d_feat", 16))
    n, e = _pad_to(n, mult), _pad_to(e, mult)

    if arch == "nequip":
        if cell.kind == "gnn_molecule":
            nb, na, ne = d["batch"], d["n_nodes"], d["n_edges"]
            return dict(
                species=b.ints((nb, na), cfg.n_species),
                positions=b.floats((nb, na, 3)),
                edge_src=b.ints((nb, ne), na),
                edge_dst=b.ints((nb, ne), na),
                edge_mask=b.bools((nb, ne)),
                energy=b.floats((nb,)))
        return dict(
            species=b.ints((n,), cfg.n_species),
            positions=b.floats((n, 3)),
            edge_src=b.ints((e,), n), edge_dst=b.ints((e,), n),
            edge_mask=b.bools((e,)),
            energy=b.floats(()))

    if arch == "graphcast":
        g = n
        m = _pad_to(max(4, n // 4), mult)
        e_g2m = 2 * g
        return dict(
            node_feats=b.floats((g, cfg.n_vars)),
            mesh_feats=b.floats((m, 3)),
            edge_src=b.ints((e,), m), edge_dst=b.ints((e,), m),
            edge_mask=b.bools((e,)),
            node_mask=b.bools((g,)),
            g2m_src=b.ints((e_g2m,), g), g2m_dst=b.ints((e_g2m,), m),
            m2g_src=b.ints((e_g2m,), m), m2g_dst=b.ints((e_g2m,), g),
            targets=b.floats((g, cfg.n_vars)))

    # graphsage full / pna
    return dict(
        node_feats=b.floats((n, dfeat)),
        edge_src=b.ints((e,), n), edge_dst=b.ints((e,), n),
        edge_mask=b.bools((e,)), node_mask=b.bools((n,)),
        labels=b.ints((n,), cfg.n_classes))


def lm_inputs(spec: ArchSpec, cell: ShapeCell, *, concrete=False,
              smoke=False, seed=0, device: DeviceLike = None
              ) -> Dict[str, Any]:
    b = _Builder(concrete, seed, device)
    cfg = spec.smoke_config if smoke else spec.config
    d = cell.dims
    if cell.kind == "train":
        bs, s = (2, 64) if smoke else (d["batch"], d["seq"])
        return dict(tokens=b.ints((bs, s), cfg.vocab),
                    labels=b.ints((bs, s), cfg.vocab))
    if cell.kind == "prefill":
        bs, s = (2, 64) if smoke else (d["batch"], d["seq"])
        return dict(tokens=b.ints((bs, s), cfg.vocab))
    # decode
    bs, ctx = (2, 64) if smoke else (d["batch"], d["ctx"])
    return dict(tokens=b.ints((bs, 1), cfg.vocab), ctx=ctx, batch=bs)


def recsys_inputs(spec: ArchSpec, cell: ShapeCell, *, concrete=False,
                  smoke=False, seed=0, device: DeviceLike = None
                  ) -> Dict[str, Any]:
    b = _Builder(concrete, seed, device)
    cfg = spec.smoke_config if smoke else spec.config
    d = cell.dims
    if cell.kind == "recsys_retrieval":
        nc = 256 if smoke else d["n_candidates"]
        return dict(query_ids=b.ints((1, cfg.n_sparse), cfg.vocab_per_field),
                    cand_ids=b.ints((nc,), cfg.vocab_per_field))
    bs = 16 if smoke else d["batch"]
    out = dict(sparse_ids=b.ints((bs, cfg.n_sparse), cfg.vocab_per_field))
    if cell.kind == "recsys_train":
        # the reference draws the labels from a fresh generator of the seed
        out["labels"] = b._put(np.random.default_rng(seed).random(bs) < 0.5,
                               F32) if concrete else b._meta((bs,), F32)
    return out


def build_inputs(spec: ArchSpec, cell: ShapeCell, **kw) -> Dict[str, Any]:
    return {"lm": lm_inputs, "gnn": gnn_inputs,
            "recsys": recsys_inputs}[spec.family](spec, cell, **kw)


# ---------------------------------------------------------------------------
# model/optimizer state per arch
# ---------------------------------------------------------------------------

MOMENT_DTYPE = {
    # bf16 moments keep the two MoE giants' optimizer state small
    "arctic-480b": torch.bfloat16,
    "qwen3-moe-30b-a3b": torch.bfloat16,
}

# gradient-accumulation microbatches for train_4k (global_batch=256)
MICROBATCHES = {
    "gemma3-12b": 4,
    "qwen2.5-3b": 2,
    "glm4-9b": 4,
    "qwen3-moe-30b-a3b": 4,
    "arctic-480b": 16,
}

# Adafactor-style factored second moments (O(n+m) vs O(nm)) — arctic only
FACTORED_V = {"arctic-480b": True}

# bf16 gradient accumulator for the 480B model
ACCUM_DTYPE = {"arctic-480b": torch.bfloat16}


def init_fn(spec: ArchSpec, smoke: bool = False):
    """``fn(generator) -> parameters``: random parameters by the
    reference's scheme, drawn from a ``torch.Generator`` on its device
    (another stream than ``jax.random``: carry the reference's own with
    ``convert.lm_params_from_numpy`` / ``gnn_params_from_numpy`` /
    ``deepfm_params_from_numpy``)."""
    cfg = spec.smoke_config if smoke else spec.config
    if spec.family == "lm":
        return partial(T.init_lm, cfg)
    if spec.family == "recsys":
        return partial(init_deepfm, cfg)
    return {
        "graphsage-reddit": partial(init_sage, cfg),
        "pna": partial(init_pna, cfg),
        "nequip": partial(init_nequip, cfg),
        "graphcast": partial(init_graphcast, cfg),
    }[spec.arch_id]


def abstract_state(spec: ArchSpec, cell: ShapeCell, smoke: bool = False,
                   with_opt: bool = True):
    """(params, opt state or None) of the cell's effective config on the
    ``meta`` device: the shapes and dtypes of ``init_fn`` and
    ``init_adamw`` (the arch's ``MOMENT_DTYPE`` and ``FACTORED_V``), with
    nothing drawn or allocated."""
    cfg = effective_config(spec, cell, smoke)
    spec_eff = dataclasses.replace(spec, config=cfg) if not smoke else spec
    params = init_fn(spec_eff, smoke)(torch.Generator(), device="meta")
    if not with_opt:
        return params, None
    opt = init_adamw(params,
                     moment_dtype=MOMENT_DTYPE.get(spec.arch_id, F32),
                     factored=FACTORED_V.get(spec.arch_id, False))
    return params, opt


def abstract_cache(spec: ArchSpec, cell: ShapeCell,
                   smoke: bool = False) -> T.KVCache:
    """The decode cell's KV cache on the ``meta`` device."""
    cfg = spec.smoke_config if smoke else spec.config
    d = cell.dims
    bs, ctx = (2, 64) if smoke else (d["batch"], d["ctx"])
    return T.init_cache(cfg, bs, ctx, device="meta")


def input_bytes(batch: Dict[str, Any]) -> int:
    """Bytes of a cell's inputs (meta tensors count their shapes)."""
    from repro_torch.models.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(batch)
               if isinstance(t, torch.Tensor))
