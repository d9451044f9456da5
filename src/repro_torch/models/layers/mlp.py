"""Feed-forward layers: SwiGLU (the decoder zoo) and a GeLU MLP (hubert).
Port of ``repro/models/layers/mlp.py``."""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.module import ParamDecl

__all__ = ["swiglu_decl", "swiglu", "gelu_mlp_decl", "gelu_mlp"]


def swiglu_decl(d: int, d_ff: int) -> dict:
    return {
        "w_gate": ParamDecl((d, d_ff), ("embed", "ff")),
        "w_up": ParamDecl((d, d_ff), ("embed", "ff")),
        "w_down": ParamDecl((d_ff, d), ("ff", "embed")),
    }


def swiglu(params, x):
    """``mlp.py:21``: matmuls in x's type (bf16), f32 weights cast at use."""
    h = F.silu(x @ params["w_gate"].to(x.dtype))
    h = h * (x @ params["w_up"].to(x.dtype))
    return h @ params["w_down"].to(x.dtype)


def gelu_mlp_decl(d: int, d_ff: int) -> dict:
    return {
        "w_in": ParamDecl((d, d_ff), ("embed", "ff")),
        "b_in": ParamDecl((d_ff,), ("ff",), init="zeros"),
        "w_out": ParamDecl((d_ff, d), ("ff", "embed")),
        "b_out": ParamDecl((d,), ("embed",), init="zeros"),
    }


def gelu_mlp(params, x):
    """``mlp.py:35``, in x's type. ``jax.nn.gelu`` is the tanh
    approximation by default, and so is this one."""
    h = F.gelu(x @ params["w_in"].to(x.dtype) + params["b_in"].to(x.dtype),
               approximate="tanh")
    return h @ params["w_out"].to(x.dtype) + params["b_out"].to(x.dtype)
