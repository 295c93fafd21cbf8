"""LR schedules (twin of ``repro.optim.schedules``)."""
import math

import torch


def warmup_cosine(step, *, peak_lr, warmup_steps, total_steps,
                  min_ratio=0.1):
    step = step.to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    progress = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * progress)))
    return torch.where(step < warmup_steps, warm, cos)
