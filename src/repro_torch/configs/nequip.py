"""nequip [arXiv:2101.03164; paper]: 5L 32ch l_max=2 n_rbf=8 cutoff=5,
E(3)-equivariant restricted tensor product (see DESIGN.md for the
CG-restriction note).

Twin of ``repro.configs.nequip``."""
import dataclasses

from repro_torch.configs.common import ArchSpec, gnn_shapes
from repro_torch.models.gnn import NequIPConfig

CONFIG = NequIPConfig(name="nequip", n_layers=5, channels=32, l_max=2,
                      n_rbf=8, cutoff=5.0, n_species=4)

SMOKE = dataclasses.replace(CONFIG, n_layers=2, channels=8, n_rbf=4)

SPEC = ArchSpec(
    arch_id="nequip", family="gnn", config=CONFIG, smoke_config=SMOKE,
    shapes=gnn_shapes(),
    notes="graph shapes map to atom-neighbour graphs; features are "
          "(species, positions); d_feat dims reinterpreted as species "
          "count context")
