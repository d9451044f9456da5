"""SwiGLU feed-forward (port of ``repro/models/layers/mlp.py``)."""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.module import ParamDecl

__all__ = ["swiglu_decl", "swiglu"]


def swiglu_decl(d: int, d_ff: int) -> dict:
    return {
        "w_gate": ParamDecl((d, d_ff)),
        "w_up": ParamDecl((d, d_ff)),
        "w_down": ParamDecl((d_ff, d)),
    }


def swiglu(params, x):
    """``mlp.py:21``: matmuls in x's type (bf16), f32 weights cast at use."""
    h = F.silu(x @ params["w_gate"].to(x.dtype))
    h = h * (x @ params["w_up"].to(x.dtype))
    return h @ params["w_down"].to(x.dtype)
