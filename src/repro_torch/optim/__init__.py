"""repro_torch.optim — AdamW, LR schedules and gradient compression (twin
of ``repro.optim``)."""
from repro_torch.optim.adamw import AdamWState, adamw_update, \
    adamw_update_, init_adamw
from repro_torch.optim.compression import compress_tree, dequantize_int8, \
    quantize_int8
from repro_torch.optim.schedules import warmup_cosine

__all__ = ["AdamWState", "adamw_update", "adamw_update_", "compress_tree",
           "dequantize_int8", "init_adamw", "quantize_int8",
           "warmup_cosine"]
