"""deepfm [arXiv:1703.04247; paper]: 39 sparse fields, embed_dim=10,
MLP 400-400-400, FM interaction.  Criteo-scale tables: 10⁶ rows/field.

Twin of ``repro.configs.deepfm``."""
import dataclasses

from repro_torch.configs.common import ArchSpec, recsys_shapes
from repro_torch.models.recsys import DeepFMConfig

CONFIG = DeepFMConfig(name="deepfm", n_sparse=39, embed_dim=10,
                      vocab_per_field=1_000_000, mlp_dims=(400, 400, 400))

SMOKE = dataclasses.replace(CONFIG, vocab_per_field=100,
                            mlp_dims=(32, 32, 32))

SPEC = ArchSpec(arch_id="deepfm", family="recsys", config=CONFIG,
                smoke_config=SMOKE, shapes=recsys_shapes())
