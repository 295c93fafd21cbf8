"""--arch <id> resolution (twin of ``repro.configs.registry``).

The port holds every architecture of the reference (five LM, four GNN and
the recsys family's ``deepfm``) and its own ``df-pagerank``, in the
reference's order.  ``NOT_PORTED`` names the reference's architectures
the port does not hold: none is left.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (arctic_480b, deepfm, gemma3_12b,
                                 glm4_9b, graphcast, graphsage_reddit,
                                 nequip, pagerank_graphs, pna, qwen2_5_3b,
                                 qwen3_moe_30b_a3b)
from repro_torch.configs.common import ArchSpec

__all__ = ["ASSIGNED_ARCHS", "NOT_PORTED", "REGISTRY", "all_cells",
           "get_arch"]

_SPECS = [
    gemma3_12b.SPEC,
    qwen2_5_3b.SPEC,
    glm4_9b.SPEC,
    qwen3_moe_30b_a3b.SPEC,
    arctic_480b.SPEC,
    graphcast.SPEC,
    graphsage_reddit.SPEC,
    nequip.SPEC,
    pna.SPEC,
    deepfm.SPEC,
    pagerank_graphs.SPEC,
]

REGISTRY: Dict[str, ArchSpec] = {s.arch_id: s for s in _SPECS}

ASSIGNED_ARCHS = [s.arch_id for s in _SPECS if s.family != "pagerank"]

# the reference's architectures the port does not hold, by family: none
NOT_PORTED: Dict[str, str] = {}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def all_cells(include_pagerank: bool = False):
    """Every (arch, shape) pair: the dry-run/roofline cell list."""
    for spec in _SPECS:
        if spec.family == "pagerank" and not include_pagerank:
            continue
        for cell in spec.shapes.values():
            yield spec, cell
