"""Streaming pairwise BPR-MF on the S&R grid — the third algorithm.

Port of ``repro/algos/bpr.py``. Per rating ``<u, i>`` the worker samples
one negative item slot ``j`` from its local split and takes one SGD step
on ``ln sigmoid(x_ui - x_uj)``:

    s  = sigmoid(-(U_u . I_i - U_u . I_j))
    U_u <- U_u + eta * (s * (I_i - I_j) - lam * U_u)
    I_i <- I_i + eta * (s * U_u         - lam * I_i)
    I_j <- I_j + eta * (-s * U_u        - lam * I_j)

Recommendation ranks by ``U_u . I_p`` as DISGD does, so BPR keeps the
``DisgdState`` container, DISGD's hit test and serve leaf
(``core/serve.partial_topn``, K3). The negative slot is
``randint(fold_in(fold_in(key, clock), u_id), 0, i_cap)`` against the
worker's live clock, so every backend replays the same draws as JAX
bit for bit. When the slot holds no usable negative (empty, the positive
itself, or already rated by ``u``) the pairwise step is skipped; the
event is still recorded. Sampling is not a touch: the negative's id,
freq and ts stay as they are.

Two worker steps, batched over the workers and updating in place like
``core/disgd.py``'s:

  * ``bpr_worker_step`` — the eager reference (``bpr.py:75``);
  * ``make_cuda_worker`` — the fast path (``make_pallas_worker``,
    ``bpr.py:178``): DISGD's bucket-start scoring (``disgd.bucket_start``,
    one ``masked_scores`` launch), the negatives of the whole bucket
    drawn at once (``negative_slots``), then one ``factor_update`` launch
    in its pairwise mode. No host synchronisation.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import algorithm as algorithm_lib
from repro_torch.core import disgd as disgd_lib
from repro_torch.core import prng
from repro_torch.core import state as state_lib
from repro_torch.core.state import DisgdState
from repro_torch.kernels import ops

__all__ = ["BprHyper", "event_clocks", "negative_slots", "bpr_worker_step",
           "make_cuda_worker", "BprAlgorithm"]


class BprHyper(NamedTuple):
    """BPR-MF hyperparameters (shared fields match the runtime contract)."""

    k: int = 10            # latent features
    eta: float = 0.05      # SGD learning rate
    lam: float = 0.01      # L2 regularization
    top_n: int = 10        # recommendation list size
    init_scale: float = 0.1
    u_cap: int = 1024
    i_cap: int = 1024
    n_i: int = 1           # item splits (slot stride)
    g: int = 1             # user groups


def event_clocks(clock: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The clock each event of a bucket sees, ``[W, E]``: the worker's
    clock at bucket start (``[W]``) plus the valid events before it
    (``bpr.py:234``)."""
    vi = valid.to(torch.int32)
    return clock[:, None] + torch.cumsum(vi, 1) - vi


def negative_slots(key: torch.Tensor, clocks: torch.Tensor,
                   u_ids: torch.Tensor, i_cap: int) -> torch.Tensor:
    """The negative slot of each event, ``randint(fold_in(fold_in(key,
    clock), u_id), 0, i_cap)`` (``bpr.py:119``, :201), as int32 of the
    events' shape. Padding (``u_id = -1``) folds in as ``0xFFFFFFFF``
    and draws too; its slot is never used."""
    keys = prng.fold_in(prng.fold_in(key, clocks), u_ids)
    return prng.randint(keys, 0, i_cap).to(torch.int32)


def bpr_worker_step(state: DisgdState, events, hyper: BprHyper,
                    key: torch.Tensor):
    """Process one micro-batch of buckets on every worker, eagerly
    (``bpr.py:75``): DISGD's recommend-first contract and bookkeeping,
    the pairwise step on a sampled local negative.

    Args:
      state: stacked ``DisgdState`` ``[W, ...]``, updated in place.
      events: ``(u_ids, i_ids)`` int32 ``[W, capacity]``, ``-1`` padding.

    Returns ``(state, hits, evaluated)`` with bool ``[W, capacity]``.
    """
    ev_u, ev_i = events
    t = state.tables
    n_w, cap = ev_u.shape
    w = torch.arange(n_w, device=ev_u.device)
    init_u = disgd_lib.init_vector(key, ev_u, hyper.k, hyper.init_scale)
    init_i = disgd_lib.init_vector(key, ev_i, hyper.k, hyper.init_scale)
    hits = torch.zeros((n_w, cap), dtype=torch.bool, device=ev_u.device)
    eta, lam = hyper.eta, hyper.lam

    for e in range(cap):
        u_id, i_id = ev_u[:, e], ev_i[:, e]
        valid = u_id >= 0
        us = state_lib.slot_of(u_id, hyper.g, hyper.u_cap).long()
        si = state_lib.slot_of(i_id, hyper.n_i, hyper.i_cap).long()
        new_u = t.user_ids[w, us] != u_id
        new_i = t.item_ids[w, si] != i_id
        u_vec = torch.where(new_u[:, None], init_u[:, e], state.user_vecs[w, us])
        i_vec = torch.where(new_i[:, None], init_i[:, e], state.item_vecs[w, si])
        # A reused slot may carry the previous tenant's history: mask it.
        rated_row = state.rated[w, us] & ~new_u[:, None]
        rated_row[w, si] &= ~new_i

        # --- recommend, then evaluate (rank by score, as DISGD) ---
        hits[:, e] = disgd_lib.recommend_hit(
            u_vec, state.item_vecs, t.item_ids, rated_row, i_id,
            hyper.top_n) & valid & ~new_i

        # --- a local negative, drawn against the live clock ---
        sj = negative_slots(key, t.clock, u_id, hyper.i_cap).long()
        neg_id = t.item_ids[w, sj]
        # sj != si: when i evicts a tenant, that tenant still holds si in
        # the pre-write tables, and a negative step on it would clobber
        # i's fresh vector.
        neg_ok = ((neg_id >= 0) & (neg_id != i_id) & (sj != si)
                  & ~rated_row[w, sj])
        upd = valid & neg_ok
        j_vec = state.item_vecs[w, sj]

        # --- pairwise BPR-SGD step ---
        x = (u_vec * i_vec).sum(-1) - (u_vec * j_vec).sum(-1)
        s = torch.sigmoid(-x)[:, None]
        ucol = upd[:, None]
        u_new = torch.where(
            ucol, u_vec + eta * (s * (i_vec - j_vec) - lam * u_vec), u_vec)
        i_new = torch.where(ucol, i_vec + eta * (s * u_vec - lam * i_vec),
                            i_vec)
        j_new = j_vec + eta * (-s * u_vec - lam * j_vec)

        # --- writes (DISGD's bookkeeping); sampling is not a touch ---
        t.clock.add_(valid.to(torch.int32))
        t.user_freq[w, us] = torch.where(
            valid, torch.where(new_u, 1, t.user_freq[w, us] + 1),
            t.user_freq[w, us])
        t.item_freq[w, si] = torch.where(
            valid, torch.where(new_i, 1, t.item_freq[w, si] + 1),
            t.item_freq[w, si])
        t.user_ids[w, us] = torch.where(valid, u_id, t.user_ids[w, us])
        t.item_ids[w, si] = torch.where(valid, i_id, t.item_ids[w, si])
        t.user_ts[w, us] = torch.where(valid, t.clock, t.user_ts[w, us])
        t.item_ts[w, si] = torch.where(valid, t.clock, t.item_ts[w, si])
        state.rated[w, :, si] = state.rated[w, :, si] & ~(valid & new_i)[:, None]
        row = state.rated[w, us] & ~(valid & new_u)[:, None]
        row[w, si] |= valid
        state.rated[w, us] = row
        vcol = valid[:, None]
        state.user_vecs[w, us] = torch.where(vcol, u_new, state.user_vecs[w, us])
        state.item_vecs[w, si] = torch.where(vcol, i_new, state.item_vecs[w, si])
        # j after i, as JAX's scatter order; never i's slot where upd.
        state.item_vecs[w, sj] = torch.where(ucol, j_new, state.item_vecs[w, sj])
    return state, hits, ev_u >= 0


def make_cuda_worker(hyper: BprHyper, key: torch.Tensor):
    """BPR worker step on the kernels (``bpr.py:178``).

    DISGD's bucket-start scoring and hit bits (``disgd.bucket_start``),
    then the negatives of every event at once, each at the clock it sees
    (``event_clocks``), so the draws equal the reference's. One ``ops.factor_update`` launch
    in pairwise mode trains every worker; it checks each negative against
    the live tables where the reference does. Returns ``step(state,
    (ev_u, ev_i)) -> (state, hits, evaluated)``.
    """
    def step(st: DisgdState, events):
        ev_u, ev_i = events
        valid, u_slot, i_slot, init_u, init_i, hits = disgd_lib.bucket_start(
            st, ev_u, ev_i, hyper, key)
        j_slot = negative_slots(key, event_clocks(st.tables.clock, valid),
                                ev_u, hyper.i_cap)
        ops.factor_update(st.user_vecs, st.item_vecs, st.rated,
                          tuple(st.tables),
                          (ev_u, ev_i, u_slot, i_slot, j_slot, init_u, init_i),
                          eta=hyper.eta, lam=hyper.lam)
        return st, hits, valid

    return step


class BprAlgorithm(algorithm_lib.DisgdAlgorithm):
    """BPR-MF — pairwise ranking on sampled local negatives. DISGD's state
    container and serve leaf (``U_u . I_p``, K3) are inherited."""

    name = "bpr"

    def default_hyper(self) -> BprHyper:
        return BprHyper()

    def make_worker_step(self, hyper, key: torch.Tensor) -> Callable:
        """The eager reference worker (``backend="scan"`` / ``"host"``)."""
        def step(state, events):
            return bpr_worker_step(state, events, hyper, key)

        return step

    def make_cuda_worker_step(self, hyper, key: torch.Tensor) -> Callable:
        """The kernel worker (``backend="cuda"``)."""
        return make_cuda_worker(hyper, key)


algorithm_lib.register(BprAlgorithm())
