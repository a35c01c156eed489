"""LR schedules of `repro.optim.schedules`, on int32 step tensors, in
float32 and in the JAX package's order of operations."""
from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr, total_steps, min_frac=0.1):
    def fn(step):
        t = torch.clamp(step.to(torch.float32) / total_steps, max=1.0)
        return base_lr * (min_frac + (1 - min_frac) * 0.5
                          * (1 + torch.cos(math.pi * t)))
    return fn


def linear_warmup_cosine(base_lr, warmup_steps, total_steps, min_frac=0.05):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1),
                          min_frac)

    def fn(step):
        step = step.to(torch.float32)
        warm = base_lr * step / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm,
                           cos(step - warmup_steps))
    return fn
