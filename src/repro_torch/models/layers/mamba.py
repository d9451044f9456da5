"""Mamba-style selective SSM (hymba's parallel-head SSM branch).

Port of ``repro/models/layers/mamba.py``. The recurrence
``s_t = a_t * s_{t-1} + b_t`` (input-dependent ``a = exp(dt * A)``,
``b = dt * B * x``) runs as a chunked scan: a Python loop over sequence
chunks carries the f32 state ``[B, d_inner, N]`` across chunk
boundaries, and inside a chunk the ``(a, b)`` pairs are combined by a
log-depth inclusive scan (Hillis–Steele: log2(chunk) rounds of whole-chunk
tensor operations), the work ``lax.associative_scan`` does in JAX. The
chunk bounds the materialised ``[B, chunk, d_inner, N]`` coefficients, as
in JAX. Decode is the exact single-step recurrence on the carried state.

JAX's module is jnp only: there is no Pallas kernel behind it, so there is
no kernel here either. Types follow JAX's: projections in x's type (bf16),
the coefficients and the scan in f32 (``cfg.ssm.scan_dtype`` inside a
chunk), the conv history in x's type.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.module import ParamDecl

__all__ = ["mamba_decl", "mamba_scan", "mamba_decode_step", "MambaState",
           "init_mamba_state", "mamba_state_decl"]


class MambaState(NamedTuple):
    ssm: torch.Tensor   # [..., B, d_inner, N] f32
    conv: torch.Tensor  # [..., B, conv_width - 1, d_inner]


def _dims(cfg):
    d_inner = cfg.ssm.expand * cfg.d_model
    dt_rank = math.ceil(cfg.d_model / 16)
    return d_inner, dt_rank, cfg.ssm.state_dim, cfg.ssm.conv_width


def mamba_decl(cfg) -> dict:
    d = cfg.d_model
    d_inner, dt_rank, n, cw = _dims(cfg)
    return {
        "w_in": ParamDecl((d, 2 * d_inner), ("embed", "inner")),
        "conv_w": ParamDecl((cw, d_inner), ("conv", "inner"), scale=0.5),
        "conv_b": ParamDecl((d_inner,), ("inner",), init="zeros"),
        "w_x": ParamDecl((d_inner, dt_rank + 2 * n), ("inner", None)),
        "w_dt": ParamDecl((dt_rank, d_inner), (None, "inner")),
        "b_dt": ParamDecl((d_inner,), ("inner",), init="zeros"),
        "log_a": ParamDecl((d_inner, n), ("inner", "state"), init="normal",
                           scale=0.5),
        "d_skip": ParamDecl((d_inner,), ("inner",), init="ones"),
        "w_out": ParamDecl((d_inner, d), ("inner", "embed")),
    }


def mamba_state_decl(cfg, batch: int, dtype="float32") -> dict:
    """A layer's decode-state declarations (``mamba.py:56``)."""
    d_inner, _, n, cw = _dims(cfg)
    return {
        "ssm": ParamDecl((batch, d_inner, n), ("batch", "inner", "state"),
                         init="zeros", dtype=dtype),
        "conv": ParamDecl((batch, cw - 1, d_inner), ("batch", None, "inner"),
                          init="zeros", dtype=dtype),
    }


def init_mamba_state(cfg, batch: int, device=None) -> MambaState:
    d_inner, _, n, cw = _dims(cfg)
    return MambaState(
        ssm=torch.zeros((batch, d_inner, n), dtype=torch.float32,
                        device=device),
        conv=torch.zeros((batch, cw - 1, d_inner), dtype=torch.float32,
                         device=device))


def _split_proj(params, x, cfg):
    """In-projection -> (pre-conv xi, gate z), in x's type."""
    d_inner = _dims(cfg)[0]
    xz = x @ params["w_in"].to(x.dtype)
    return xz[..., :d_inner], xz[..., d_inner:]


def _ssm_coeffs(params, xc, cfg):
    """Input-dependent (a, b, c) from the conv output xc [B, S, d_inner],
    in f32 (``mamba.py:91``): a, b [B, S, d_inner, N], c [B, S, N]."""
    _, dt_rank, n, _ = _dims(cfg)
    proj = xc @ params["w_x"].to(xc.dtype)
    dt_in = proj[..., :dt_rank]
    b_in = proj[..., dt_rank:dt_rank + n].float()
    c_in = proj[..., dt_rank + n:].float()
    dt = F.softplus(dt_in.float() @ params["w_dt"].float()
                    + params["b_dt"].float())
    a = -torch.exp(params["log_a"].float())
    da = torch.exp(dt[..., None] * a)
    db = dt[..., None] * b_in[..., None, :] * xc.float()[..., None]
    return da, db, c_in


def _causal_conv(params, xi, cfg, history=None):
    """Depthwise causal conv1d as a sum of shifted products, in xi's type
    (``mamba.py:108``). xi [B, S, d_inner]; ``history`` the previous
    ``conv_width - 1`` inputs. Returns (silu(out), the new history)."""
    cw = _dims(cfg)[3]
    if history is None:
        pad = xi.new_zeros((xi.shape[0], cw - 1, xi.shape[2]))
    else:
        pad = history.to(xi.dtype)
    xp = torch.cat([pad, xi], dim=1)          # [B, S + cw - 1, d_inner]
    w = params["conv_w"].to(xi.dtype)         # [cw, d_inner]
    s = xi.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + s] * w[i]
    out = out + params["conv_b"].to(xi.dtype)
    new_hist = xp[:, -(cw - 1):] if cw > 1 else pad
    return F.silu(out), new_hist


def _prefix_scan(a, b):
    """Inclusive scan along dim 1 of the pairs (a, b) under
    ``(al, bl) . (ar, br) = (al * ar, bl * ar + br)`` (left earlier):
    Hillis–Steele, each round combining every position with the one
    ``k`` before it, k = 1, 2, 4, ... Returns new tensors (autograd keeps
    each round's inputs): (prod of a, the state from a zero start)."""
    n, k = a.shape[1], 1
    while k < n:
        b = torch.cat([b[:, :k], torch.addcmul(b[:, k:], a[:, k:], b[:, :-k])],
                      dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return a, b


def mamba_scan(params, x, cfg, state: MambaState | None = None):
    """Full-sequence selective scan (``mamba.py:126``). x [B, S, D] ->
    (y [B, S, D], the final ``MambaState``)."""
    b, s, _ = x.shape
    chunk = min(cfg.ssm.chunk, s)
    while s % chunk:  # the largest divisor of s not above the chunk size
        chunk -= 1
    if state is None:
        state = init_mamba_state(cfg, b, x.device)

    xi, z = _split_proj(params, x, cfg)
    xc, conv_hist = _causal_conv(params, xi, cfg, state.conv)
    scan_dtype = getattr(torch, cfg.ssm.scan_dtype)

    carry = state.ssm.float()
    ys = []
    for c0 in range(0, s, chunk):
        da, db, c_c = _ssm_coeffs(params, xc[:, c0:c0 + chunk], cfg)
        a_cum, s_cum = _prefix_scan(da.to(scan_dtype), db.to(scan_dtype))
        states = torch.addcmul(s_cum.float(), a_cum.float(),
                               carry[:, None])       # [B, chunk, d_inner, N]
        ys.append(torch.einsum("bsdn,bsn->bsd", states, c_c))
        carry = states[:, -1]
    y = torch.cat(ys, dim=1)

    y = y + params["d_skip"].float() * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    out = y @ params["w_out"].to(x.dtype)
    return out, MambaState(ssm=carry.contiguous(), conv=conv_hist)


def mamba_decode_step(params, x, cfg, state: MambaState):
    """Single-token step (``mamba.py:163``). x [B, 1, D] -> (y, new
    state)."""
    xi, z = _split_proj(params, x, cfg)
    xc, conv_hist = _causal_conv(params, xi, cfg, state.conv)
    da, db, c_in = _ssm_coeffs(params, xc, cfg)
    new_ssm = da[:, 0] * state.ssm.float() + db[:, 0]
    y = torch.einsum("bdn,bn->bd", new_ssm, c_in[:, 0])[:, None, :]
    y = y + params["d_skip"].float() * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    out = y @ params["w_out"].to(x.dtype)
    return out, MambaState(ssm=new_ssm, conv=conv_hist)
