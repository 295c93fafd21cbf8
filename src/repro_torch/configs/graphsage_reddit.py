"""graphsage-reddit [arXiv:1706.02216; paper]: 2 layers, d_hidden 128,
mean aggregator, sample sizes 25-10 (Reddit: 232,965 nodes / 114.6 M
edges).  Twin of ``repro.configs.graphsage_reddit``."""
import dataclasses

from repro_torch.configs.common import ArchSpec, gnn_shapes
from repro_torch.models.gnn import SAGEConfig

CONFIG = SAGEConfig(name="graphsage-reddit", n_layers=2, d_hidden=128,
                    d_in=602, n_classes=41, fanouts=(25, 10))

SMOKE = dataclasses.replace(CONFIG, d_hidden=16, d_in=12, n_classes=5,
                            fanouts=(3, 2))

SPEC = ArchSpec(
    arch_id="graphsage-reddit", family="gnn", config=CONFIG,
    smoke_config=SMOKE, shapes=gnn_shapes(),
    notes="DF frontier integrates: incremental embedding refresh "
          "(core/incremental_gnn.py)")
