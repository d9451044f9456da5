"""LR schedules (port of ``repro/optim/schedule.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["cosine_schedule"]


def cosine_schedule(step, *, peak: float, warmup: int, total: int,
                    floor_pct: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``floor_pct * peak``: a 0-d f32
    tensor on the CPU (a Python number to the optimizer, no device read).

    The JAX function's types, copied: an array ``step`` (tensor, numpy)
    is taken in f32 throughout; a Python number keeps the warmup ramp
    and the cosine's argument in Python floats, rounded to f32 where
    they meet an array (``jnp.clip``, ``jnp.where``)."""
    if torch.is_tensor(step) or isinstance(step, (np.ndarray, np.generic)):
        step = torch.as_tensor(step, dtype=torch.float32).cpu()
    else:
        step = float(step)
    warm = torch.as_tensor(peak * step / max(warmup, 1), dtype=torch.float32)
    t = torch.clamp(torch.as_tensor((step - warmup) / max(total - warmup, 1),
                                    dtype=torch.float32), 0.0, 1.0)
    floor = floor_pct * peak
    cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * t))
    return torch.where(torch.as_tensor(step < warmup), warm, cos)
