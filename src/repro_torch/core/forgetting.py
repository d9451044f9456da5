"""Forgetting techniques (paper Section 5.2): state eviction and decay.

Port of ``repro/core/forgetting.py``: ``ForgettingConfig`` (:45),
``apply_forgetting`` (:92) and ``evict_to_budget`` (:146).
``ForgettingConfig.policy`` selects one of four policies:

  * ``"lfu"`` — evicts users / items seen fewer than ``lfu_min_freq``
    times;
  * ``"lru"`` — evicts users / items untouched for more than
    ``lru_max_age`` events of the worker's clock;
  * ``"gradual"`` — no eviction: every pass decays the learned state by
    ``gradual_gamma`` (DISGD / BPR-MF factor vectors, DICS co-occurrence
    counts), ids and history survive;
  * ``"none"`` — identity.

An evicted entry's id becomes ``-1``, its frequency and timestamp 0, its
factor vector zero; its ``rated`` row (users) or column (items) is
cleared, and for DICS its ``co`` row and column and ``item_cnt`` too.

The port updates states IN PLACE, as its workers do, and returns the
same object. Every pass is elementwise over the tables with the masks
broadcast, so it allocates nothing the size of the state (``rated`` is
4.2 GB on the DISGD deployment): masks and a 0-d factor only.

The trigger is the caller's. JAX gates the pass with ``lax.cond`` on a
device flag; the port's device loop never synchronizes with the host,
so it passes the flag as ``gate`` (a 0-d bool tensor) and runs the pass
on every step with the flag folded in: the masks are ANDed with it and
``gradual`` multiplies by ``where(gate, gamma, 1)``. When the flag is
false the pass writes back what it read, so the result is JAX's bit for
bit either way.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.state import DicsState, DisgdState, Tables

__all__ = ["ForgettingConfig", "apply_forgetting", "evict_to_budget"]


class ForgettingConfig(NamedTuple):
    policy: str = "none"        # "none" | "lru" | "lfu" | "gradual"
    # Trigger cadence in processed events. Granularity is one micro-batch
    # (at most one trigger per batch); the accumulator carries its
    # remainder across triggers, so for micro_batch <= trigger_every the
    # count is exactly floor(processed / trigger_every).
    trigger_every: int = 4096   # c records (LFU) / t clock ticks (LRU)
    lfu_min_freq: int = 2       # evict entries seen fewer than this
    lru_max_age: int = 8192     # evict entries untouched for this many events
    gradual_gamma: float = 0.98  # decay factor of a gradual pass


def _masks(t: Tables, cfg: ForgettingConfig):
    """(user, item) eviction masks of an ``lru`` / ``lfu`` pass."""
    u_live, i_live = t.user_ids >= 0, t.item_ids >= 0
    if cfg.policy == "lfu":
        return (u_live & (t.user_freq < cfg.lfu_min_freq),
                i_live & (t.item_freq < cfg.lfu_min_freq))
    if cfg.policy == "lru":
        clock = t.clock[..., None]
        return (u_live & (clock - t.user_ts > cfg.lru_max_age),
                i_live & (clock - t.item_ts > cfg.lru_max_age))
    raise ValueError(f"unknown forgetting policy {cfg.policy!r}")


def apply_forgetting(state, cfg: ForgettingConfig, gate=None):
    """One scan-and-evict (or decay) pass over a (stacked) worker state,
    in place; ``gate`` (a 0-d bool tensor) runs it only where true."""
    if cfg.policy == "none":
        return state
    if cfg.policy == "gradual":
        return _apply_gradual(state, cfg.gradual_gamma, gate)
    u_evict, i_evict = _masks(state.tables, cfg)
    if gate is not None:
        u_evict, i_evict = u_evict & gate, i_evict & gate
    return _apply_masks(state, u_evict, i_evict)


def _apply_gradual(state, gamma: float, gate=None):
    """Exponential decay: f32 state times f32(gamma), as XLA multiplies
    by a weakly typed Python float; times 1.0 (exact) where the gate is
    false."""
    # Two Python floats give a float32 0-d tensor on the gate's device
    # (one kernel: no host copy, so no synchronization).
    factor = gamma if gate is None else torch.where(gate, gamma, 1.0)
    if isinstance(state, DisgdState):
        state.user_vecs.mul_(factor)
        state.item_vecs.mul_(factor)
    elif isinstance(state, DicsState):
        state.co.mul_(factor)
        state.item_cnt.mul_(factor)
    else:
        raise TypeError(f"unknown state type {type(state)}")
    return state


def _apply_masks(state, u_evict, i_evict):
    """Evict the masked entries in place (``forgetting.py:124-143``)."""
    t = state.tables
    t.user_ids.masked_fill_(u_evict, -1)
    t.item_ids.masked_fill_(i_evict, -1)
    for tab, mask in ((t.user_freq, u_evict), (t.item_freq, i_evict),
                      (t.user_ts, u_evict), (t.item_ts, i_evict)):
        tab.masked_fill_(mask, 0)
    _clear_rated(state.rated, u_evict, i_evict)
    if isinstance(state, DisgdState):
        state.user_vecs.masked_fill_(u_evict[..., None], 0.0)
        state.item_vecs.masked_fill_(i_evict[..., None], 0.0)
    elif isinstance(state, DicsState):
        # JAX multiplies by the f32 keep mask of rows and columns.
        keep = (~i_evict).to(state.co.dtype)
        state.co.mul_(keep[..., :, None]).mul_(keep[..., None, :])
        state.item_cnt.masked_fill_(i_evict, 0.0)
    else:
        raise TypeError(f"unknown state type {type(state)}")
    return state


def _clear_rated(rated: torch.Tensor, u_evict, i_evict) -> None:
    """``rated &= ~u_evict[:, None] & ~i_evict[None, :]`` in place.

    Two passes with the masks broadcast (rows, then columns), no
    temporary the size of ``rated``. Each pass works on the widest words
    the row length allows (8 bytes at the deployment's 6,784 items):
    ``logical_and_`` on bool bytes ran at a quarter of the card's memory
    rate. The row mask is all-ones or zero words, the column mask a word
    of 0xFF / 0x00 bytes, so the result is the byte-wise AND exactly.
    """
    width = next(w for w in (8, 4, 2, 1) if rated.shape[-1] % w == 0)
    dtype = {8: torch.int64, 4: torch.int32, 2: torch.int16,
             1: torch.uint8}[width]
    words = rated.view(torch.uint8).view(dtype)
    words.bitwise_and_((~u_evict).to(dtype).neg_()[..., :, None])
    keep = (~i_evict).to(torch.uint8).mul_(0xFF)
    words.bitwise_and_(keep.view(dtype)[..., None, :])


def evict_to_budget(state, user_budget: int, item_budget: int,
                    policy: str = "lru"):
    """Hard memory bound, in place: keep the best ``budget`` live entries
    of each worker by recency (``lru``: ``ts``) or frequency (``lfu``)
    and evict the rest. Entries above the budget-th best score always
    survive; those tied at it compete in slot order for what is left."""
    t = state.tables
    if policy == "lru":
        u_score, i_score = t.user_ts, t.item_ts
    elif policy == "lfu":
        u_score, i_score = t.user_freq, t.item_freq
    else:
        raise ValueError(policy)

    def mask(score, ids, budget):
        live = ids >= 0
        if budget <= 0:
            return live             # zero budget: evict every live entry
        score = torch.where(live, score, torch.iinfo(torch.int32).min)
        # Threshold = budget-th largest score among the slots.
        kth = torch.topk(score, min(budget, score.shape[-1]),
                         dim=-1).values[..., -1:]
        above = live & (score > kth)
        tied = live & (score == kth)
        tied_budget = budget - above.sum(-1, keepdim=True, dtype=torch.int32)
        tie_rank = torch.cumsum(tied.to(torch.int32), -1)   # 1-based
        keep = above | (tied & (tie_rank <= tied_budget))
        return live & ~keep

    return _apply_masks(state, mask(u_score, t.user_ids, user_budget),
                        mask(i_score, t.item_ids, item_budget))
