"""Learning-rate schedules, pure functions of the step (port of
``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up (nonzero at step 0), then a cosine decay to
    ``final_frac * peak_lr``; an fp32 scalar tensor."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * (step + 1) / max(warmup_steps, 1)
    progress = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                           0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * progress)))
    return torch.where(step < warmup_steps, warm, cos)
