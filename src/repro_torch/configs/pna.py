"""pna [arXiv:2004.05718; paper]: 4L d_hidden=75, aggregators
mean/max/min/std × scalers identity/amplification/attenuation.

Twin of ``repro.configs.pna``."""
import dataclasses

from repro_torch.configs.common import ArchSpec, gnn_shapes
from repro_torch.models.gnn import PNAConfig

CONFIG = PNAConfig(name="pna", n_layers=4, d_hidden=75, d_in=16,
                   n_classes=10)

SMOKE = dataclasses.replace(CONFIG, n_layers=2, d_hidden=12, d_in=6,
                            n_classes=3)

SPEC = ArchSpec(arch_id="pna", family="gnn", config=CONFIG,
                smoke_config=SMOKE, shapes=gnn_shapes())
