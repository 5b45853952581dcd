"""Learning-rate schedules on a tensor step (the port of
``repro/train/schedule.py``): f32 arithmetic in the reference's order."""

from __future__ import annotations

import math

import torch


def _as_tensor(step) -> torch.Tensor:
    return step if isinstance(step, torch.Tensor) else torch.as_tensor(step)


def linear_warmup(step, warmup_steps: int):
    step = _as_tensor(step)
    return torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)


def cosine_schedule(step, total_steps: int, warmup_steps: int = 0,
                    final_frac: float = 0.1):
    step = _as_tensor(step)
    w = linear_warmup(step, warmup_steps)
    prog = torch.clamp((step - warmup_steps) /
                       max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return w * (final_frac + (1.0 - final_frac) * cos)
