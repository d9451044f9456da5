"""AdamW as plain functions over parameter tensors (port of
``repro/optim/adamw.py``).

JAX's order of operations, kept for parity (``torch.optim.AdamW`` orders
the update otherwise): the global-norm clip first; f32 bias corrections
``1 - b ** count``; ``(m / b1c) / (sqrt(v / b2c) + eps)`` plus
``weight_decay * p``; then ``p - lr * step``.

A parameter tree is a ``torch.nn.Module`` (its ``parameters()`` in
order), a dict (leaves in sorted-key order, as ``jax.tree`` flattens),
a list or tuple, or one tensor; ``m``, ``v`` and the gradients are
flat lists in that order. The update runs on the device with
``torch._foreach_*`` and never reads a value on the host. It works IN
PLACE, where JAX returns new arrays: the parameters, ``m`` and ``v``
are updated, the gradients are consumed (scaled by the clip, then their
storage holds the update's denominator), and the returned parameters
are the tree passed in.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

__all__ = ["AdamWState", "adamw_init", "adamw_update", "leaves"]


class AdamWState(NamedTuple):
    m: list          # f32, one per parameter leaf
    v: list
    count: torch.Tensor   # int32 [] on the parameters' device


def leaves(tree) -> list:
    """The tree's tensors in ``jax.tree``'s order (a module: its
    ``parameters()``)."""
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [t for x in tree for t in leaves(x)]


def adamw_init(params) -> AdamWState:
    ps = leaves(params)
    zeros = [torch.zeros_like(p, dtype=torch.float32) for p in ps]
    return AdamWState(
        m=zeros, v=[torch.zeros_like(z) for z in zeros],
        count=torch.zeros((), dtype=torch.int32,
                          device=ps[0].device if ps else None))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float | None = 1.0,
                 gnorm=None):
    """One AdamW step (``adamw.py:29``), IN PLACE. ``lr``: a number or a
    0-d CPU tensor (``cosine_schedule``'s), read on the host. ``gnorm``:
    the gradients' global norm when the caller has it (a sharded step's
    gradients are blocks of the whole model's: ``sharding.fsdp``); by
    default the norm of ``grads``. Returns (params, the new state, the
    gradients' global norm before the clip, f32 [] on the device; 0
    without a clip)."""
    ps, gs = leaves(params), leaves(grads)
    m, v = list(state.m), list(state.v)
    if not len(ps) == len(gs) == len(m) == len(v):
        raise ValueError(f"adamw_update: {len(ps)} parameters, {len(gs)} "
                         f"gradients, {len(m)} / {len(v)} moments")
    count = state.count + 1
    device = count.device
    gs = [g if g.dtype == torch.float32 else g.float() for g in gs]

    if grad_clip is not None:
        if gnorm is None:
            gnorm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(gs)))
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        torch._foreach_mul_(gs, scale)
    else:
        gnorm = torch.zeros((), dtype=torch.float32, device=device)

    cf = count.float()
    b1c = 1.0 - torch.pow(b1, cf)
    b2c = 1.0 - torch.pow(b2, cf)

    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, gs, alpha=1 - b1)
    torch._foreach_mul_(v, b2)
    torch._foreach_addcmul_(v, gs, gs, value=1 - b2)

    den = gs                                  # the gradients are spent
    torch._foreach_copy_(den, v)
    torch._foreach_div_(den, b2c)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    step = torch._foreach_div(m, b1c)
    torch._foreach_div_(step, den)
    torch._foreach_add_(step, ps, alpha=weight_decay)
    torch._foreach_add_(ps, step, alpha=-float(lr))
    return params, AdamWState(m=m, v=v, count=count), gnorm
