"""Learning-rate schedules, pure functions of the step (port of
``repro/optim/schedules.py``), in float32 on the step's device.

Every constant enters as a float32 operand of the reference's operation,
in its order; divisors are tensors, since dividing a CUDA tensor by a
Python number multiplies by the reciprocal, which can be an ulp off.
"""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> torch.Tensor:
    step = _step(step)

    def f32(v):
        return step.new_full((), v)

    warm = f32(peak_lr) * step / f32(max(warmup_steps, 1))
    progress = torch.clamp((step - f32(warmup_steps))
                           / f32(max(total_steps - warmup_steps, 1)), 0.0, 1.0)
    # the float32 cosine correctly rounded (through float64), as the
    # reference's gives it: PyTorch's float32 cos can be an ulp off, which
    # 1 + cos near -1 multiplies
    angle = f32(math.pi) * progress
    cosine = torch.cos(angle.to(torch.float64)).to(torch.float32)
    cos = f32(peak_lr) * (f32(final_frac) + f32((1 - final_frac) * 0.5)
                          * (f32(1.0) + cosine))
    return torch.where(step < f32(warmup_steps), warm, cos)


def constant(step, *, peak_lr: float) -> torch.Tensor:
    return torch.full_like(_step(step), peak_lr)
