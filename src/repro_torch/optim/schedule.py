"""Learning-rate schedules (warmup + cosine / constant / rsqrt).

Counterpart of ``repro/optim/schedule.py``: float32 throughout, as the
reference casts ``step`` to float32 first.  ``step`` may be a Python number
or a tensor; the result is a 0-dim float32 tensor on the step's device.
"""
from __future__ import annotations

import math

import torch

from ._ieee import sqrt

__all__ = ["warmup_cosine", "warmup_rsqrt", "constant"]


def _f32(step) -> torch.Tensor:
    if torch.is_tensor(step):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def warmup_cosine(step, peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    step = _f32(step)
    warm = peak_lr * step / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)


def warmup_rsqrt(step, peak_lr: float, warmup: int):
    step = _f32(step)
    warm = peak_lr * step / max(warmup, 1)
    # a tensor divisor by hand: ``number / tensor`` multiplies by the
    # reciprocal in PyTorch, one rounding more than the reference's division
    ratio = torch.full_like(step, warmup) / torch.clamp(step, min=1)
    return torch.where(step < warmup, warm, peak_lr * sqrt(ratio))


def constant(step, peak_lr: float, warmup: int = 0):
    step = _f32(step)
    if warmup:
        return torch.clamp(peak_lr * step / warmup, max=peak_lr)
    return torch.full_like(step, peak_lr)
