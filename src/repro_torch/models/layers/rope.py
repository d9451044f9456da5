"""Rotary position embeddings (port of ``repro/models/layers/rope.py``)."""

from __future__ import annotations

import torch

__all__ = ["apply_rope"]


def apply_rope(x, positions, *, theta: float = 10_000.0,
               rope_pct: float = 1.0):
    """Apply RoPE to ``x`` ``[B, H, S, D]`` (``rope.py:10``).

    ``positions`` is ``[S]`` (prefill: broadcast over batch and heads) or
    ``[B, S]`` (decode: batch leading, heads inserted after it). Angles
    and cos/sin are f32; the rotated half is computed in f32 (x's type
    promotes against them) and cast back to x's type. ``rope_pct < 1``
    rotates only the leading fraction of the head dim.
    """
    d = x.shape[-1]
    d_rot = int(d * rope_pct)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    rot, rest = x[..., :d_rot], x[..., d_rot:]

    half = d_rot // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=x.device) / half
    # A Python base: no host-to-device copy, so decode never syncs.
    freqs = torch.pow(float(theta), exponent)
    angles = positions[..., None].float() * freqs          # [..., S, half]
    cos, sin = torch.cos(angles), torch.sin(angles)
    if cos.ndim == 2:
        # positions [S]: broadcast over batch/heads from the left.
        while cos.ndim < rot.ndim:
            cos, sin = cos[None], sin[None]
    else:
        # positions [B, S]: keep batch leading, add head dims after it.
        while cos.ndim < rot.ndim:
            cos, sin = cos[:, None], sin[:, None]

    x1, x2 = rot[..., :half], rot[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                        dim=-1).to(x.dtype)
    if rest.shape[-1] == 0:
        return rotated
    return torch.cat([rotated, rest], dim=-1)
