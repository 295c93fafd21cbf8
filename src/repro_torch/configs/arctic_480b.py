"""arctic-480b [hf:Snowflake/snowflake-arctic-base; hf]: MoE LM, 35L
d_model=7168 56H GQA(kv=8) dense d_ff=4864, vocab=32000, 128 experts top-2
PLUS dense residual MLP (dense+MoE hybrid).

Twin of ``repro.configs.arctic_480b``."""
import dataclasses

from repro_torch.configs.common import ArchSpec, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="arctic-480b", n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000, n_experts=128, top_k=2, moe_d_ff=4864,
    dense_residual=True, rope_theta=10000.0)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
    vocab=512, n_experts=8, top_k=2, moe_d_ff=64, dense_residual=True,
    dtype="float32")

SPEC = ArchSpec(
    arch_id="arctic-480b", family="lm", config=CONFIG, smoke_config=SMOKE,
    shapes=lm_shapes(full_attention_only=True))
