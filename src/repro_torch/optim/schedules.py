"""LR schedules as step -> multiplier callables (multiplied by base lr);
each returns a float32 tensor on the step's device."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_schedule():
    def sched(step):
        return torch.ones_like(_f32(step))

    return sched


def cosine_schedule(total_steps: int, final_frac: float = 0.0):
    def sched(step):
        t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return final_frac + (1.0 - final_frac) * cos

    return sched


def linear_warmup_cosine(warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    def sched(step):
        step = _f32(step)
        warm = step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1.0 - final_frac) * 0.5 * (
            1.0 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, cos)

    return sched


def exponential_decay(decay_steps: int, decay_rate: float = 0.5):
    def sched(step):
        return decay_rate ** (_f32(step) / max(decay_steps, 1))

    return sched
