"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B; hf]: MoE LM, 48L d_model=2048
32H GQA(kv=4) per-expert d_ff=768, vocab=151936, 128 experts top-8.

Twin of ``repro.configs.qwen3_moe_30b_a3b``."""
import dataclasses

from repro_torch.configs.common import ArchSpec, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
    n_kv_heads=4, d_ff=0, vocab=151936, n_experts=128, top_k=8,
    moe_d_ff=768, rope_theta=1_000_000.0)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, vocab=512,
    n_experts=8, top_k=2, moe_d_ff=32, dtype="float32")

SPEC = ArchSpec(
    arch_id="qwen3-moe-30b-a3b", family="lm", config=CONFIG,
    smoke_config=SMOKE, shapes=lm_shapes(full_attention_only=True))
