"""Optimizers of the port (the codec's Adam), as in ``repro.optim``."""
from repro_torch.optim.optimizers import (
    AdamState,
    Optimizer,
    adam,
    adamw,
    apply_updates,
    clip_by_global_norm,
    global_norm,
)

__all__ = [
    "AdamState",
    "Optimizer",
    "adam",
    "adamw",
    "apply_updates",
    "global_norm",
    "clip_by_global_norm",
]
