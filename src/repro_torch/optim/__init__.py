"""Optimizers and learning-rate schedules of the port, as in ``repro.optim``."""
from repro_torch.optim.optimizers import (
    AdamState,
    Optimizer,
    adam,
    adamw,
    apply_updates,
    clip_by_global_norm,
    clip_by_global_norm_,
    global_norm,
)
from repro_torch.optim.schedules import constant, cosine, wsd

__all__ = [
    "AdamState",
    "Optimizer",
    "adam",
    "adamw",
    "apply_updates",
    "global_norm",
    "clip_by_global_norm",
    "clip_by_global_norm_",
    "constant",
    "cosine",
    "wsd",
]
