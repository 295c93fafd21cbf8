"""qwen2.5-3b [hf:Qwen/Qwen2.5-0.5B family; hf]: dense LM, 36L d_model=2048
16H GQA(kv=2) d_ff=11008 vocab=151936, QKV bias, full attention.

Twin of ``repro.configs.qwen2_5_3b``."""
import dataclasses

from repro_torch.configs.common import ArchSpec, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="qwen2.5-3b", n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab=151936, qkv_bias=True, rope_theta=1_000_000.0)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab=512, dtype="float32")

SPEC = ArchSpec(
    arch_id="qwen2.5-3b", family="lm", config=CONFIG, smoke_config=SMOKE,
    shapes=lm_shapes(full_attention_only=True))
