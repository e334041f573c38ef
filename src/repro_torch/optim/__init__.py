"""Optimizer substrate: AdamW with decoupled weight decay, global-norm
gradient clipping, and LR schedules. State is a tree mirroring the params
tree."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
)
from repro_torch.optim.clipping import clip_by_global_norm, global_norm
from repro_torch.optim.schedules import (
    constant_schedule,
    cosine_schedule,
    exponential_decay,
    linear_warmup_cosine,
)

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "AdamWConfig",
    "constant_schedule",
    "cosine_schedule",
    "linear_warmup_cosine",
    "exponential_decay",
    "global_norm",
    "clip_by_global_norm",
]
