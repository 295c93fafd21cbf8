"""gemma3-12b [hf:google/gemma-3-1b-pt pattern; unverified]: dense LM,
48L d_model=3840 16H GQA(kv=8) d_ff=15360 vocab=262144, 5:1 local:global
attention (window 1024), 128k context.

Twin of ``repro.configs.gemma3_12b``."""
import dataclasses

from repro_torch.configs.common import ArchSpec, lm_shapes
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="gemma3-12b", n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
    d_ff=15360, vocab=262144, window=1024, global_every=6,
    rope_theta=1_000_000.0)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, window=16, global_every=2, dtype="float32")

SPEC = ArchSpec(
    arch_id="gemma3-12b", family="lm", config=CONFIG, smoke_config=SMOKE,
    shapes=lm_shapes(full_attention_only=False),
    notes="5:1 local:global hybrid -> long_500k decode cell runs")
