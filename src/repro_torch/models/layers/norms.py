"""RMS and layer normalisation (port of ``repro/models/layers/norms.py``)."""

from __future__ import annotations

import torch

from repro_torch.models.module import ParamDecl

__all__ = ["rmsnorm_decl", "rmsnorm", "layernorm_decl", "layernorm"]


def rmsnorm_decl(d: int) -> dict:
    return {"scale": ParamDecl((d,), ("embed",), init="ones")}


def rmsnorm(params, x, eps: float = 1e-5):
    """``repro/models/layers/norms.py:17``: in f32, cast back to x's type."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * params["scale"].float()
    return y.to(dtype)


def layernorm_decl(d: int) -> dict:
    return {"scale": ParamDecl((d,), ("embed",), init="ones"),
            "bias": ParamDecl((d,), ("embed",), init="zeros")}


def layernorm(params, x, eps: float = 1e-5):
    """``norms.py:32``: mean and (biased) variance in f32, cast back to
    x's type."""
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(dtype)
