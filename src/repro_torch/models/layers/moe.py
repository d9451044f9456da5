"""Mixture-of-Experts with capacity-bucketed dispatch.

Port of ``repro/models/layers/moe.py`` (:33-114). Tokens go in groups of
``group_size`` (capacity is per group); an f32 router softmax picks each
token's ``top_k`` experts; each (token, k) assignment takes a position
in its expert's bucket from an exclusive count of the group's earlier
assignments to that expert, and assignments past the bucket's capacity
are dropped (``core/routing.bucket_dispatch``'s rule). The experts are
SwiGLUs in the activation type, with optional shared experts on every
token, plus the switch load-balance aux loss.

JAX dispatches through one-hot einsums over ``[G, Tg, E, C]``; this
port gathers each bucket slot's token into a fixed ``[E, G, C, D]``
buffer and gathers each assignment's expert output back. Every slot
holds at most one token, so both are exact, and every shape follows
from the input's shape alone: no ``nonzero``, no ``.item()``, no boolean
indexing, so a decode step only enqueues work on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers.mlp import swiglu, swiglu_decl
from repro_torch.models.module import ParamDecl

__all__ = ["moe_decl", "moe_apply", "route", "Routing", "group_shape"]


def moe_decl(cfg) -> dict:
    d, e = cfg.d_model, cfg.moe
    decl = {
        "router": ParamDecl((d, e.n_experts), ("embed", "experts"),
                            scale=0.1),
        "w_gate": ParamDecl((e.n_experts, d, e.d_expert),
                            ("experts", "embed", None)),
        "w_up": ParamDecl((e.n_experts, d, e.d_expert),
                          ("experts", "embed", None)),
        "w_down": ParamDecl((e.n_experts, e.d_expert, d),
                            ("experts", None, "embed")),
    }
    if e.n_shared:
        decl["shared"] = swiglu_decl(d, e.n_shared * e.d_expert)
    return decl


def _capacity(tg: int, top_k: int, n_experts: int, factor: float) -> int:
    """Bucket slots per expert and group (``moe.py:52``)."""
    c = math.ceil(tg * top_k * factor / n_experts)
    c = max(c, min(top_k, tg))
    return min(int(c), tg)


def group_shape(t: int, e) -> tuple[int, int, int]:
    """(groups, group size, capacity) for ``t`` tokens: the group size is
    the largest divisor of ``t`` not above ``group_size`` (``moe.py:63``),
    so a ragged token count changes the groups and the capacity."""
    gs = min(e.group_size, t)
    while t % gs:
        gs -= 1
    return t // gs, gs, _capacity(gs, e.top_k, e.n_experts,
                                  e.capacity_factor)


class Routing(NamedTuple):
    top_i: torch.Tensor   # [G, Tg, K] int64 expert of each assignment
    top_p: torch.Tensor   # [G, Tg, K] f32 renormalized router weight
    pos: torch.Tensor     # [G, Tg, K] int64 position in the expert's bucket
    kept: torch.Tensor    # [G, Tg, K] bool, pos < capacity
    probs: torch.Tensor   # [G, Tg, E] f32 router softmax
    aux: torch.Tensor     # [] f32 switch load-balance loss
    capacity: int


def route(params, xt, e) -> Routing:
    """The router and the bucketing of ``xt`` [G, Tg, D] (``moe.py:68-92``).

    The top-k keeps JAX's rule on ties (``lax.top_k``): by probability
    descending, the lowest expert index first; a stable sort gives that
    on every device (``torch.topk`` does not promise it). Positions are
    counted in int32, exact on any device: a token never picks an
    expert twice, so an assignment's position is the number of the
    group's earlier tokens that picked the same expert, whatever k.
    """
    g, tg, _ = xt.shape
    cap = _capacity(tg, e.top_k, e.n_experts, e.capacity_factor)
    logits = torch.einsum("gtd,de->gte", xt.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :e.top_k], top_i[..., :e.top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    picked = torch.zeros((g, tg, e.n_experts), dtype=torch.int32,
                         device=xt.device).scatter_(-1, top_i, 1)
    frac_tokens = picked.float().mean(dim=1) / e.top_k        # [G, E]
    frac_probs = probs.mean(dim=1)                             # [G, E]
    aux = e.n_experts * torch.mean(torch.sum(frac_tokens * frac_probs, -1))

    before = torch.cumsum(picked, dim=1, dtype=torch.int32) - picked
    pos = torch.gather(before, -1, top_i).long()
    return Routing(top_i, top_p, pos, pos < cap, probs, aux, cap)


def _experts(params, xin, dtype):
    """SwiGLU of every expert on its rows: xin [E, R, D] -> [E, R, D],
    matmuls in ``dtype`` with the f32 weights cast at use."""
    h = F.silu(torch.bmm(xin, params["w_gate"].to(dtype)))
    h = h * torch.bmm(xin, params["w_up"].to(dtype))
    return torch.bmm(h, params["w_down"].to(dtype))


def moe_apply(params, x, cfg, batch=None):
    """x [B, S, D] -> ([B, S, D] in x's type, aux loss f32 []).

    ``batch`` (a ``sharding.ctx.BatchShard``: ``n`` blocks, this rank's
    ``block``, ``gather_rows``) says that x is this rank's rows of a
    batch split over ranks. Then the groups are those of the whole
    batch: a group size from the whole token count, and the aux loss
    this rank's share of the mean over every group (the shares sum to
    the whole batch's aux). When the ranks' rows do not split into whole
    groups, this rank routes the whole batch (``batch.gather_rows``) and
    keeps its rows."""
    if batch is None or batch.n == 1:
        return _moe(params, x, cfg)
    n, block = batch.n, batch.block
    b, s, d = x.shape
    g_all, gs, _ = group_shape(b * s * n, cfg.moe)
    if (b * s) % gs:
        y, aux = _moe(params, batch.gather_rows(x), cfg)
        return y[block * b:(block + 1) * b], aux / n
    y, aux = _moe(params, x, cfg, gs)
    return y, aux * ((b * s // gs) / g_all)


def _moe(params, x, cfg, gs=None):
    """``moe_apply`` on groups of ``gs`` tokens (default: ``group_shape``
    of x's tokens); aux the mean over x's groups."""
    e = cfg.moe
    b, s, d = x.shape
    t = b * s
    if gs is None:
        g, gs, _ = group_shape(t, e)
    else:
        g = t // gs
    xt = x.reshape(g, gs, d)
    r = route(params, xt, e)
    cap, n_e, k = r.capacity, e.n_experts, e.top_k
    dev = x.device

    # Bucket slot of each kept assignment in the [E, G, C] buffer; dropped
    # ones aim at one spare slot past the end, discarded.
    group = torch.arange(g, device=dev)[:, None, None]
    slot = (r.top_i * g + group) * cap + r.pos
    slot = torch.where(r.kept, slot, n_e * g * cap).reshape(-1)
    token = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    # The token each slot holds; an empty slot reads a zero row (index t).
    src = torch.full((n_e * g * cap + 1,), t, dtype=torch.long, device=dev)
    src.scatter_(0, slot, token)
    rows = torch.cat([x.reshape(t, d), x.new_zeros((1, d))])
    xin = rows[src[:-1]].view(n_e, g * cap, d)
    out = _experts(params, xin, x.dtype).view(n_e * g * cap, d)

    # Combine: each kept assignment's expert row times its router weight
    # rounded to the activation type (JAX's ``combine`` einsum, f32, then
    # cast), summed over k with an f32 accumulator.
    w = torch.where(r.kept, r.top_p, 0.0).to(x.dtype).view(t, 1, k)
    picked = out[torch.where(r.kept.reshape(-1), slot, 0)].view(t, k, d)
    y = torch.bmm(w, picked).view(g, gs, d)
    if e.n_shared:
        y = y + swiglu(params["shared"], xt)
    return y.reshape(b, s, d), r.aux
