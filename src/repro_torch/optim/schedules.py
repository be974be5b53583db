"""Learning-rate schedules: constant, cosine, and WSD, as in
``repro.optim.schedules``.

Each schedule maps an integer step tensor to an f32 learning rate on the
step's device, with the reference's arithmetic: the step cast to f32, the
same clips and the same ``where`` order.  Nothing is read back to the
host and no tensor is made from a Python number on the card (that copy
waits for the stream): the constant is a fill of the step's shape.

WSD (warmup-stable-decay) is included because ``minicpm-2b`` trains with
it (arXiv:2404.06395).
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=F32, device=step.device)


def cosine(lr: float, total_steps: int, warmup: int = 0, min_ratio: float = 0.1):
    def sched(step):
        step = step.to(F32)
        warm = lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total_steps - warmup, 1), 0, 1)
        cos = lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return sched


def wsd(lr: float, total_steps: int, warmup: int = 0, decay_frac: float = 0.1,
        min_ratio: float = 0.01):
    """Warmup -> stable plateau -> linear decay over the last decay_frac."""
    decay_steps = max(int(total_steps * decay_frac), 1)
    decay_start = total_steps - decay_steps

    def sched(step):
        step = step.to(F32)
        warm = lr * step / max(warmup, 1)
        frac = torch.clamp((step - decay_start) / decay_steps, 0, 1)
        dec = lr * (1 - (1 - min_ratio) * frac)
        out = torch.where(step < warmup, warm, torch.full_like(step, lr))
        return torch.where(step > decay_start, dec, out)

    return sched
