"""glm4-9b [hf:THUDM/glm-4-9b; hf]: dense LM, 40L d_model=4096 32H
GQA(kv=2) d_ff=13696 vocab=151552, RoPE, full attention.

Twin of ``repro.configs.glm4_9b``."""
import dataclasses

from repro_torch.configs.common import ArchSpec, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="glm4-9b", n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=151552, rope_theta=10000.0)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab=512, dtype="float32")

SPEC = ArchSpec(
    arch_id="glm4-9b", family="lm", config=CONFIG, smoke_config=SMOKE,
    shapes=lm_shapes(full_attention_only=True))
