"""Optimizer and LR schedule for LM training (port of ``repro/optim``)."""

from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule"]
