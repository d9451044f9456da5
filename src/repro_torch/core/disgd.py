"""DISGD — Distributed Incremental SGD matrix factorization (paper Alg. 2).

Port of ``repro/core/disgd.py``. Per rating ``<u, i>`` on the worker that
Algorithm 1 selects: recommend first (prequential Recall@N, Alg. 4), then
train (``err = 1 - U_u . I_i``; ``U_u += eta (err I_i - lam U_u)``,
``I_i += eta (err U_u - lam I_i)``), drawing unseen vectors from
``N(0, init_scale)`` through ``fold_in(key, global_id)`` so every replica
of an id starts identical.

Two worker steps, both batched over a leading worker axis ``[n_c, ...]``
and both updating the state IN PLACE (the rated tables are gigabytes at
deployment size; a functional copy per micro-batch would dominate):

  * ``disgd_worker_step`` — the eager reference (``disgd.py:88``), one
    event position at a time over all workers, recall per event against
    the live state;
  * ``make_cuda_worker`` — the fast path (``make_pallas_worker``,
    ``disgd.py:189``): one ``masked_scores`` launch scores every bucket at
    its start, the hit bits are rank counts over those scores
    (``bucket_start``, which BPR's kernel worker shares), then one
    ``factor_update`` launch trains every worker. Final states equal the
    reference's (integers exactly); recall bits follow the bucket-start
    contract of the JAX fast path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import prng
from repro_torch.core import state as state_lib
from repro_torch.core.state import DisgdState
from repro_torch.kernels import ops

__all__ = ["DisgdHyper", "init_vector", "score_items", "disgd_worker_step",
           "make_cuda_worker", "bucket_start", "bucket_start_hits",
           "recommend_hit"]


class DisgdHyper(NamedTuple):
    """Paper hyperparameters (Section 5.3.1)."""

    k: int = 10            # latent features
    eta: float = 0.05      # learning rate (paper's mu)
    lam: float = 0.01      # L2 regularization
    top_n: int = 10        # recommendation list size
    init_scale: float = 0.1
    u_cap: int = 1024
    i_cap: int = 1024
    n_i: int = 1           # item splits (for slot mapping)
    g: int = 1             # user groups


def init_vector(key: torch.Tensor, global_ids: torch.Tensor, k: int,
                scale: float) -> torch.Tensor:
    """Deterministic ``N(0, scale)`` init shared by all replicas of an id:
    ``f32[..., k]`` for ids ``[...]`` (``disgd.py:55``)."""
    return scale * prng.normal(prng.fold_in(key, global_ids), k)


def score_items(u_vec, item_vecs, item_ids, rated_row):
    """Scores of every local item per worker, masking empties and rated:
    u_vec [W, k], item_vecs [W, I, k], item_ids / rated_row [W, I]."""
    scores = torch.bmm(item_vecs, u_vec[:, :, None])[:, :, 0]
    valid = (item_ids >= 0) & ~rated_row
    return scores.masked_fill(~valid, float("-inf"))


def recommend_hit(u_vec, item_vecs, item_ids, rated_row, i_id, top_n: int):
    """Is ``i_id`` in the top-N list (``disgd.py:69``)? A rank count: fewer
    than N candidates outrank the target (strictly greater score, or an
    equal score at a lower slot, as ``lax.top_k`` breaks ties)."""
    scores = score_items(u_vec, item_vecs, item_ids, rated_row)
    i_cap = scores.shape[-1]
    eq = item_ids == i_id[:, None]
    t_slot = eq.to(torch.int32).argmax(-1, keepdim=True)
    s_t = torch.where(eq.gather(1, t_slot), scores.gather(1, t_slot),
                      float("-inf"))
    slots = torch.arange(i_cap, device=scores.device)
    ahead = (scores > s_t).sum(-1) + ((scores == s_t) & (slots < t_slot)).sum(-1)
    return torch.isfinite(s_t[:, 0]) & (ahead < min(top_n, i_cap))


def disgd_worker_step(state: DisgdState, events, hyper: DisgdHyper,
                      key: torch.Tensor):
    """Process one micro-batch of buckets on every worker, eagerly.

    Args:
      state: stacked ``DisgdState`` ``[W, ...]``, updated in place.
      events: ``(u_ids, i_ids)`` int32 ``[W, capacity]``, ``-1`` padding.

    Returns ``(state, hits, evaluated)`` with bool ``[W, capacity]``
    prequential Recall@N bits and validity.
    """
    ev_u, ev_i = events
    t = state.tables
    n_w, cap = ev_u.shape
    w = torch.arange(n_w, device=ev_u.device)
    init_u = init_vector(key, ev_u, hyper.k, hyper.init_scale)
    init_i = init_vector(key, ev_i, hyper.k, hyper.init_scale)
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

        # --- recommend, then evaluate (Alg. 4 lines 1-5) ---
        hits[:, e] = recommend_hit(u_vec, state.item_vecs, t.item_ids,
                                   rated_row, i_id, hyper.top_n) & valid & ~new_i

        # --- incremental SGD update (Alg. 2) ---
        err = 1.0 - (u_vec * i_vec).sum(-1, keepdim=True)
        u_new = u_vec + eta * (err * i_vec - lam * u_vec)
        i_new = i_vec + eta * (err * u_vec - lam * i_vec)

        # --- writes; padding events write back what they read ---
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
        # Collision eviction: clear the evicted item's column, then the
        # evicted user's row, then mark the rated pair.
        state.rated[w, :, si] = state.rated[w, :, si] & ~(valid & new_i)[:, None]
        row = state.rated[w, us] & ~(valid & new_u)[:, None]
        row[w, si] |= valid
        state.rated[w, us] = row
        vcol = valid[:, None]
        state.user_vecs[w, us] = torch.where(vcol, u_new, state.user_vecs[w, us])
        state.item_vecs[w, si] = torch.where(vcol, i_new, state.item_vecs[w, si])
    return state, hits, ev_u >= 0


def bucket_start_hits(scores, i_slots, known_i, top_n: int):
    """Recall bits from bucket-start scores ``f32[W, E, I]``: the target
    slot ranks in the top ``min(top_n, I)`` by (score desc, slot asc),
    which is ``lax.top_k``'s order, and its score is finite."""
    s_t = scores.gather(2, i_slots[..., None].long())
    slots = torch.arange(scores.shape[-1], device=scores.device)
    ahead = ((scores > s_t).sum(-1)
             + ((scores == s_t) & (slots < i_slots[..., None])).sum(-1))
    return (known_i & torch.isfinite(s_t[..., 0])
            & (ahead < min(top_n, scores.shape[-1])))


def bucket_start(st: DisgdState, ev_u, ev_i, hyper, key: torch.Tensor):
    """The bucket-start half of the factor-model kernel workers (DISGD
    here, BPR in ``repro_torch/algos/bpr.py``): the events' slots and
    init vectors, then one ``ops.masked_scores`` launch scoring every
    worker's bucket against the state at bucket start and the hit bits
    as rank counts at the target slot (``bucket_start_hits``). Returns
    ``(valid, u_slot, i_slot, init_u, init_i, hits)``."""
    cap = ev_u.shape[1]
    valid = ev_u >= 0
    t = st.tables
    u_slot = state_lib.slot_of(ev_u, hyper.g, hyper.u_cap)
    i_slot = state_lib.slot_of(ev_i, hyper.n_i, hyper.i_cap)
    us = u_slot.long()
    # "Known at bucket start": the slot already holds this exact id.
    known_u = t.user_ids.gather(1, us) == ev_u
    known_i = t.item_ids.gather(1, i_slot.long()) == ev_i
    init = init_vector(key, torch.cat([ev_u, ev_i], 1), hyper.k,
                       hyper.init_scale)
    init_u = init[:, :cap].contiguous()
    init_i = init[:, cap:].contiguous()

    w = torch.arange(ev_u.shape[0], device=ev_u.device)[:, None]
    u_vecs_b = torch.where(known_u[..., None], st.user_vecs[w, us], init_u)
    rated_rows = st.rated[w, us] & known_u[..., None]
    cand = (t.item_ids >= 0)[:, None, :] & ~rated_rows & valid[..., None]
    scores = ops.masked_scores(u_vecs_b, st.item_vecs, cand)
    hits = bucket_start_hits(scores, i_slot, known_i & valid, hyper.top_n)
    return valid, u_slot, i_slot, init_u, init_i, hits


def make_cuda_worker(hyper: DisgdHyper, key: torch.Tensor):
    """DISGD worker step on the kernels (``disgd.py:189``).

    ``bucket_start`` scores every worker's bucket in one
    ``ops.masked_scores`` launch and takes the hit bits from it, then one
    ``ops.factor_update`` launch trains every worker, event by event.
    Returns ``step(state, (ev_u, ev_i)) -> (state, hits, evaluated)``
    like ``disgd_worker_step``.
    """
    def step(st: DisgdState, events):
        ev_u, ev_i = events
        valid, u_slot, i_slot, init_u, init_i, hits = bucket_start(
            st, ev_u, ev_i, hyper, key)
        # --- train (one fused update launch: exact reference semantics) ---
        ops.factor_update(st.user_vecs, st.item_vecs, st.rated,
                          tuple(st.tables),
                          (ev_u, ev_i, u_slot, i_slot, None, init_u, init_i),
                          eta=hyper.eta, lam=hyper.lam)
        return st, hits, valid

    return step
