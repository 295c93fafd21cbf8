"""--arch <id> resolution (twin of ``repro.configs.registry``).

The port holds the reference's four GNN architectures and its own
``df-pagerank``.  The LM and recsys architectures are not ported yet
(ROADMAP queue 1, item 6): ``get_arch`` names them as such instead of
failing as an unknown id.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (graphcast, graphsage_reddit, nequip,
                                 pagerank_graphs, pna)
from repro_torch.configs.common import ArchSpec

_SPECS = [
    graphcast.SPEC,
    graphsage_reddit.SPEC,
    nequip.SPEC,
    pna.SPEC,
    pagerank_graphs.SPEC,
]

REGISTRY: Dict[str, ArchSpec] = {s.arch_id: s for s in _SPECS}

ASSIGNED_ARCHS = [s.arch_id for s in _SPECS if s.family != "pagerank"]

# the reference's architectures the port does not hold yet, by family
NOT_PORTED = {
    "gemma3-12b": "lm", "qwen2.5-3b": "lm", "glm4-9b": "lm",
    "qwen3-moe-30b-a3b": "lm", "arctic-480b": "lm", "deepfm": "recsys",
}


def not_ported(what: str) -> NotImplementedError:
    """The error for a part of the reference the port does not hold
    yet."""
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1, item 6: the LM "
        f"family and recsys.py come in later slices)")


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in NOT_PORTED:
        raise not_ported(f"arch {arch_id!r} ({NOT_PORTED[arch_id]} "
                         f"family)")
    if arch_id not in REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def all_cells(include_pagerank: bool = False):
    """Every (arch, shape) pair of the ported architectures."""
    for spec in _SPECS:
        if spec.family == "pagerank" and not include_pagerank:
            continue
        for cell in spec.shapes.values():
            yield spec, cell
