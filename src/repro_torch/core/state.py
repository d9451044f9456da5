"""Per-worker slot-mapped state for the S&R recommenders, as tensors.

Port of ``repro/core/state.py``: ``slot_of`` (:43), ``user_slot`` /
``item_slot``, ``Tables`` (:64), ``DisgdState`` (:76), ``DicsState``
(:85), ``init_disgd_state`` (:120), ``init_dics_state`` (:131),
``occupancy`` (:151) and ``item_stats`` (:159), plus ``clone_state``
(the port's snapshot copy). Each worker holds fixed-capacity id-slotted
tables, ``slot(id) = (id // n_splits) % capacity``; empty slots carry id
``-1``. Ids and bookkeeping are int32 as in JAX (indexing casts to
int64); ``rated`` is ``torch.bool`` and a kernel reads it through
``.view(torch.uint8)`` without a copy.

The state containers are shape-agnostic: one worker, or a stacked grid
with a leading ``[n_c]`` axis (``init_disgd_state(..., batch=(n_c,))``),
which is the layout the engine, the kernels and the serving plane use.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Tables", "DisgdState", "DicsState", "init_disgd_state",
           "init_dics_state", "slot_of", "user_slot", "item_slot",
           "occupancy", "item_stats", "clone_state"]


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


class DicsState(NamedTuple):
    """DICS worker state: co-rating counts for the incremental cosine.

    With positive-only boolean feedback, ``co[p, q]`` counts the users who
    rated both p and q and ``item_cnt[p]`` those who rated p, so Eq. 6 is
    ``co[p, q] / sqrt(item_cnt[p] * item_cnt[q])``. Both hold integer
    values in f32. The JAX state's ``co_scale`` (storage policies) has no
    counterpart until the storage slice.
    """

    tables: Tables
    co: torch.Tensor         # f32[..., I_cap, I_cap]
    item_cnt: torch.Tensor   # f32[..., I_cap]
    rated: torch.Tensor      # bool[..., U_cap, I_cap]


def _tables(full, u_cap: int, i_cap: int) -> Tables:
    i32 = torch.int32
    return Tables(
        user_ids=full((u_cap,), -1, i32),
        item_ids=full((i_cap,), -1, i32),
        user_freq=full((u_cap,), 0, i32),
        item_freq=full((i_cap,), 0, i32),
        user_ts=full((u_cap,), 0, i32),
        item_ts=full((i_cap,), 0, i32),
        clock=full((), 0, i32),
    )


def _filler(batch: tuple, device):
    def full(shape, value, dtype):
        return torch.full(batch + shape, value, dtype=dtype, device=device)

    return full


def init_disgd_state(u_cap: int, i_cap: int, k: int, *, batch: tuple = (),
                     device="cuda") -> DisgdState:
    """Zero state of ``batch`` workers (``()`` = one worker)."""
    full = _filler(batch, device)
    return DisgdState(
        tables=_tables(full, u_cap, i_cap),
        user_vecs=full((u_cap, k), 0.0, torch.float32),
        item_vecs=full((i_cap, k), 0.0, torch.float32),
        rated=full((u_cap, i_cap), False, torch.bool),
    )


def init_dics_state(u_cap: int, i_cap: int, *, batch: tuple = (),
                    device="cuda") -> DicsState:
    """Zero DICS state of ``batch`` workers (``()`` = one worker)."""
    full = _filler(batch, device)
    return DicsState(
        tables=_tables(full, u_cap, i_cap),
        co=full((i_cap, i_cap), 0.0, torch.float32),
        item_cnt=full((i_cap,), 0.0, torch.float32),
        rated=full((u_cap, i_cap), False, torch.bool),
    )


def occupancy(tables: Tables):
    """Paper's memory metric: live entries per table (per worker)."""
    return ((tables.user_ids >= 0).sum(-1, dtype=torch.int32),
            (tables.item_ids >= 0).sum(-1, dtype=torch.int32))


def item_stats(state):
    """Per-slot (global item id, popularity weight) for either algorithm:
    ``item_freq`` touches for DISGD, the Eq. 6 ``item_cnt`` for DICS.
    Shapes follow the state (one worker or a stacked grid)."""
    if isinstance(state, DicsState):
        return state.tables.item_ids, state.item_cnt
    if isinstance(state, DisgdState):
        return state.tables.item_ids, state.tables.item_freq.float()
    raise TypeError(f"unknown state type {type(state)}")


def clone_state(state):
    """A copy of a (stacked) worker state on its device, enqueued on the
    current stream. The port updates states in place, so a snapshot that
    must not change under its reader is a copy (a JAX state is immutable
    and needs none)."""
    return type(state)(Tables(*(t.clone() for t in state.tables)),
                       *(t.clone() for t in state[1:]))
