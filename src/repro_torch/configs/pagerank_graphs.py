"""The paper's own workload configs: dynamic-graph PageRank at scale.

Graph size classes mirror paper Table 1 (temporal) and Table 2 (large
static).  These drive the distributed-PageRank dry-run (the paper's
technique on the production mesh) — the 40 assigned (arch × shape) cells
are defined in the other config modules.  Twin of
``repro.configs.pagerank_graphs``.
"""
import dataclasses
from typing import Dict

from repro_torch.configs.common import ArchSpec, ShapeCell


@dataclasses.dataclass(frozen=True)
class PageRankConfig:
    name: str = "df-pagerank"
    alpha: float = 0.85
    tol: float = 1e-10
    frontier_tol: float = 1e-6
    prune_tol: float = 1e-6
    max_iter: int = 500


CONFIG = PageRankConfig()
SMOKE = dataclasses.replace(CONFIG, tol=1e-8)

# V/E classes: sx-stackoverflow (largest temporal), com-Orkut (social),
# sk-2005 (largest web graph in Table 2), europe_osm (road, low degree).
SHAPES: Dict[str, ShapeCell] = {
    "temporal_so": ShapeCell(
        "temporal_so", "pagerank",
        dict(n_vertices=2_601_977, edge_capacity=40_000_000,
             batch_edges=6_340)),       # 1e-4|E_T|
    "social_orkut": ShapeCell(
        "social_orkut", "pagerank",
        dict(n_vertices=3_072_441, edge_capacity=237_000_000,
             batch_edges=23_700)),
    "web_sk2005": ShapeCell(
        "web_sk2005", "pagerank",
        dict(n_vertices=50_636_154, edge_capacity=1_980_000_000,
             batch_edges=198_000)),
    "road_europe": ShapeCell(
        "road_europe", "pagerank",
        dict(n_vertices=50_912_018, edge_capacity=159_000_000,
             batch_edges=15_900)),
}

SPEC = ArchSpec(arch_id="df-pagerank", family="pagerank", config=CONFIG,
                smoke_config=SMOKE, shapes=SHAPES,
                notes="the paper's own workload on the production mesh")
