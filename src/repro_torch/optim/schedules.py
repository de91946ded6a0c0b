"""Learning-rate schedules (port of ``repro.optim.schedules``): functions
of the int32 step that return an f32 scalar tensor, computed in f32 as
the JAX package computes them."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=torch.as_tensor(step).device)


def linear_warmup(lr: float, warmup: int):
    def fn(step):
        s = _f32(step)
        return torch.tensor(lr, dtype=torch.float32, device=s.device) \
            * torch.clamp(s / max(warmup, 1), max=1.0)
    return fn


def cosine(lr: float, warmup: int, total: int, final_frac: float = 0.1):
    def fn(step):
        s = _f32(step)
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.tensor(lr, dtype=torch.float32, device=s.device) \
            * warm * cos
    return fn
