"""graphcast [arXiv:2212.12794; unverified]: encoder-processor-decoder
mesh GNN, 16L d_hidden=512 sum aggregator, n_vars=227, mesh refinement 6.

Twin of ``repro.configs.graphcast``."""
import dataclasses

from repro_torch.configs.common import ArchSpec, gnn_shapes
from repro_torch.models.gnn import GraphCastConfig

CONFIG = GraphCastConfig(name="graphcast", n_layers=16, d_hidden=512,
                         n_vars=227, mesh_refinement=6)

SMOKE = dataclasses.replace(CONFIG, n_layers=2, d_hidden=32, n_vars=11)

SPEC = ArchSpec(
    arch_id="graphcast", family="gnn", config=CONFIG, smoke_config=SMOKE,
    shapes=gnn_shapes(),
    notes="shape n_nodes -> grid nodes; mesh nodes = n_nodes//4; "
          "n_edges -> mesh-mesh edges; g2m/m2g = 2 per grid node")
