"""RMS normalisation (port of ``repro/models/layers/norms.py``)."""

from __future__ import annotations

import torch

from repro_torch.models.module import ParamDecl

__all__ = ["rmsnorm_decl", "rmsnorm"]


def rmsnorm_decl(d: int) -> dict:
    return {"scale": ParamDecl((d,), init="ones")}


def rmsnorm(params, x, eps: float = 1e-5):
    """``repro/models/layers/norms.py:17``: in f32, cast back to x's type."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * params["scale"].float()
    return y.to(dtype)
