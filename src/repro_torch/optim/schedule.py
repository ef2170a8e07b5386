"""LR schedules (pure functions of the step counter), in PyTorch.

The counterpart of ``repro.optim.schedule``.  The arithmetic runs in fp32
tensors, as ``jnp`` runs it: Python constants enter each product as fp32,
so the lr is the reference's value.
"""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1
                    ) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine decay to
    ``min_ratio * peak_lr`` at ``total_steps``.  ``step``: an int or a
    tensor (the result lives on its device), as a 0-dim fp32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    progress = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1.0 + torch.cos(math.pi * progress)))
    return torch.where(step < warmup_steps, warm, cos)
