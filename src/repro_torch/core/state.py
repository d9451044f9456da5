"""Per-worker slot-mapped state for the S&R recommenders, as tensors.

Port of ``repro/core/state.py``: ``slot_of`` (:43), ``user_slot`` /
``item_slot``, ``Tables`` (:64), ``DisgdState`` (:76),
``init_disgd_state`` (:120) and ``occupancy`` (:151). Each worker holds
fixed-capacity id-slotted tables, ``slot(id) = (id // n_splits) %
capacity``; empty slots carry id ``-1``. Ids and bookkeeping are int32
as in JAX (indexing casts to int64); ``rated`` is ``torch.bool`` and a
kernel reads it through ``.view(torch.uint8)`` without a copy.

The state containers are shape-agnostic: one worker, or a stacked grid
with a leading ``[n_c]`` axis (``init_disgd_state(..., batch=(n_c,))``),
which is the layout the engine, the kernels and the serving plane use.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Tables", "DisgdState", "init_disgd_state", "slot_of",
           "user_slot", "item_slot", "occupancy"]


def slot_of(ids: torch.Tensor, n_splits: int, capacity: int) -> torch.Tensor:
    """Map global id(s) to a local table slot (floor division, as JAX)."""
    return (ids // n_splits) % capacity


def user_slot(ids, grid, capacity: int):
    """User-table slot(s) on a ``grid``-shaped worker (stride ``g``)."""
    return slot_of(ids, grid.g, capacity)


def item_slot(ids, grid, capacity: int):
    """Item-table slot(s) on a ``grid``-shaped worker (stride ``n_i``)."""
    return slot_of(ids, grid.n_i, capacity)


class Tables(NamedTuple):
    """Bookkeeping: ids / frequency / last-touch clock per slot."""

    user_ids: torch.Tensor   # i32[..., U_cap], -1 = empty
    item_ids: torch.Tensor   # i32[..., I_cap]
    user_freq: torch.Tensor  # i32[..., U_cap]
    item_freq: torch.Tensor  # i32[..., I_cap]
    user_ts: torch.Tensor    # i32[..., U_cap]
    item_ts: torch.Tensor    # i32[..., I_cap]
    clock: torch.Tensor      # i32[...], per-worker event counter


class DisgdState(NamedTuple):
    """DISGD worker state: local shards of the factor matrices U and I."""

    tables: Tables
    user_vecs: torch.Tensor  # f32[..., U_cap, k]
    item_vecs: torch.Tensor  # f32[..., I_cap, k]
    rated: torch.Tensor      # bool[..., U_cap, I_cap]


def init_disgd_state(u_cap: int, i_cap: int, k: int, *, batch: tuple = (),
                     device="cuda") -> DisgdState:
    """Zero state of ``batch`` workers (``()`` = one worker)."""
    def full(shape, value, dtype):
        return torch.full(batch + shape, value, dtype=dtype, device=device)

    i32 = torch.int32
    return DisgdState(
        tables=Tables(
            user_ids=full((u_cap,), -1, i32),
            item_ids=full((i_cap,), -1, i32),
            user_freq=full((u_cap,), 0, i32),
            item_freq=full((i_cap,), 0, i32),
            user_ts=full((u_cap,), 0, i32),
            item_ts=full((i_cap,), 0, i32),
            clock=full((), 0, i32),
        ),
        user_vecs=full((u_cap, k), 0.0, torch.float32),
        item_vecs=full((i_cap, k), 0.0, torch.float32),
        rated=full((u_cap, i_cap), False, torch.bool),
    )


def occupancy(tables: Tables):
    """Paper's memory metric: live entries per table (per worker)."""
    return ((tables.user_ids >= 0).sum(-1, dtype=torch.int32),
            (tables.item_ids >= 0).sum(-1, dtype=torch.int32))
