"""Per-worker slot-mapped state for the S&R recommenders, as tensors.

Port of ``repro/core/state.py``: ``slot_of`` (:43), ``user_slot`` /
``item_slot``, ``Tables`` (:64), ``DisgdState`` (:76), ``DicsState``
(:85), ``init_disgd_state`` (:120), ``init_dics_state`` (:131),
``occupancy`` (:151) and ``item_stats`` (:159), plus ``clone_state``
(the port's snapshot copy). ``init_disgd_state`` / ``init_dics_state``
take ``storage=`` (a ``core.storage.StoragePolicy``) and return the zero
state in that policy's resident encoding, as JAX's ``_maybe_encode``. Each worker holds fixed-capacity id-slotted
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
           "occupancy", "item_stats", "clone_state", "signed"]


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
    values in f32. ``co_scale`` exists only under a quantized storage
    policy (``core.storage``): the per-row scales of ``co``. In the
    compute form, everything the algorithms see, it is ``None``, as in
    JAX (so both packages' states have the same five fields).
    """

    tables: Tables
    co: torch.Tensor         # f32[..., I_cap, I_cap] (or its encoding)
    item_cnt: torch.Tensor   # f32[..., I_cap]
    rated: torch.Tensor      # bool[..., U_cap, I_cap] (uint32 if packed)
    co_scale: torch.Tensor | None = None   # f32[..., I_cap], or None


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
                     device="cuda", storage=None) -> DisgdState:
    """Zero state of ``batch`` workers (``()`` = one worker)."""
    full = _filler(batch, device)
    return _maybe_encode(DisgdState(
        tables=_tables(full, u_cap, i_cap),
        user_vecs=full((u_cap, k), 0.0, torch.float32),
        item_vecs=full((i_cap, k), 0.0, torch.float32),
        rated=full((u_cap, i_cap), False, torch.bool),
    ), storage)


def init_dics_state(u_cap: int, i_cap: int, *, batch: tuple = (),
                    device="cuda", storage=None) -> DicsState:
    """Zero DICS state of ``batch`` workers (``()`` = one worker)."""
    full = _filler(batch, device)
    return _maybe_encode(DicsState(
        tables=_tables(full, u_cap, i_cap),
        co=full((i_cap, i_cap), 0.0, torch.float32),
        item_cnt=full((i_cap,), 0.0, torch.float32),
        rated=full((u_cap, i_cap), False, torch.bool),
    ), storage)


def _maybe_encode(state, storage):
    """Encode a fresh compute-form state per an optional StoragePolicy."""
    if storage is None:
        return state
    from repro_torch.core import storage as storage_lib

    return storage_lib.encode_state(state, storage)


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
    def clone(t):
        # Unsigned tables (packed rated, quantized co) copy through their
        # signed view: PyTorch's kernels cover the signed types.
        return None if t is None else signed(t).clone().view(t.dtype)

    return type(state)(Tables(*(clone(t) for t in state.tables)),
                       *(clone(t) for t in state[1:]))


_SIGNED = {torch.uint32: torch.int32, torch.uint16: torch.int16}


def signed(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or for an unsigned 16 / 32-bit table (a packed
    ``rated``, a quantized ``co``) the signed view of the same memory:
    PyTorch has few operations on the unsigned types (no shifts, sums or
    ``index_put``)."""
    s = _SIGNED.get(t.dtype)
    return t if s is None else t.view(s)
