"""Config-system spine: ArchSpec, ShapeCell, per-family shape tables (twin
of ``repro.configs.common``, copied as it is)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture × input-shape) dry-run cell."""
    name: str
    kind: str                 # train | prefill | decode | gnn_* | recsys_*
    dims: Dict[str, int]
    skip: Optional[str] = None    # reason string when the cell is skipped


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str               # lm | gnn | recsys | pagerank
    config: Any
    smoke_config: Any
    shapes: Dict[str, ShapeCell]
    notes: str = ""


def lm_shapes(full_attention_only: bool) -> Dict[str, ShapeCell]:
    """The LM-family shape set (same four cells for every LM arch).

    ``long_500k`` lowers ``serve_step`` (decode) — linear in context — but
    per the assignment it is skipped for pure full-attention archs and run
    for local/hybrid ones (gemma3's 5:1 local:global qualifies).
    """
    cells = {
        "train_4k": ShapeCell("train_4k", "train",
                              dict(seq=4096, batch=256)),
        "prefill_32k": ShapeCell("prefill_32k", "prefill",
                                 dict(seq=32768, batch=32)),
        "decode_32k": ShapeCell("decode_32k", "decode",
                                dict(ctx=32768, batch=128)),
        "long_500k": ShapeCell(
            "long_500k", "decode", dict(ctx=524288, batch=1),
            skip=("pure full-attention arch: 500k-context cell skipped per "
                  "assignment (no sub-quadratic mechanism)"
                  ) if full_attention_only else None),
    }
    return cells


def gnn_shapes() -> Dict[str, ShapeCell]:
    return {
        "full_graph_sm": ShapeCell(
            "full_graph_sm", "gnn_full",
            dict(n_nodes=2708, n_edges=10556, d_feat=1433)),
        "minibatch_lg": ShapeCell(
            "minibatch_lg", "gnn_minibatch",
            dict(n_nodes=232_965, n_edges=114_615_892, batch_nodes=1024,
                 fanout0=15, fanout1=10)),
        "ogb_products": ShapeCell(
            "ogb_products", "gnn_full",
            dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100)),
        "molecule": ShapeCell(
            "molecule", "gnn_molecule",
            dict(n_nodes=30, n_edges=64, batch=128)),
    }


def recsys_shapes() -> Dict[str, ShapeCell]:
    return {
        "train_batch": ShapeCell("train_batch", "recsys_train",
                                 dict(batch=65536)),
        "serve_p99": ShapeCell("serve_p99", "recsys_serve",
                               dict(batch=512)),
        "serve_bulk": ShapeCell("serve_bulk", "recsys_serve",
                                dict(batch=262144)),
        "retrieval_cand": ShapeCell("retrieval_cand", "recsys_retrieval",
                                    dict(batch=1, n_candidates=1_000_000)),
    }
