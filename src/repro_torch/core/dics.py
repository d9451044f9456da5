"""DICS — Distributed Incremental Cosine Similarity (paper Alg. 3).

Port of ``repro/core/dics.py``: item-based CF with TencentRec's
incremental cosine (Eq. 6) on the S&R grid. Per worker, ``co[p, q]``
counts the users who rated both p and q and ``item_cnt[p]`` those who
rated p, so ``sim(p, q) = co[p, q] / sqrt(item_cnt[p] * item_cnt[q])``.
Per event ``<u, i>``: recommend first (candidates ranked by the top-k_nn
neighbour mass over the user's history, Eq. 7; Recall@N bit), then
``co[i, q] += 1`` and ``co[q, i] += 1`` for every ``q`` in the history,
``item_cnt[i] += 1``, mark ``rated[u, i]``.

Two worker steps, both batched over a leading worker axis ``[n_c, ...]``
and both updating the state IN PLACE:

  * ``dics_worker_step`` — the eager reference (``dics.py:134``), one
    event position at a time over all workers, each event scored against
    the live statistics;
  * ``make_cuda_worker`` — the fast path (``make_pallas_worker``,
    ``dics.py:218``): Eq. 6 once per bucket, every event scored against
    the bucket-start statistics in PyTorch (as the JAX fast path scores
    outside its kernels), then one ``dics_update`` launch trains every
    worker. Final states equal the reference's exactly.

When every worker's bucket is padding only, neither step changes any
state: the JAX engine skips a step with no events, so its unguarded
padding clears never run there. Both steps compute that flag (``live``)
from their events over all workers, which hold an event whenever the
device loop's step does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import state as state_lib
from repro_torch.core import storage as storage_lib
from repro_torch.core.disgd import bucket_start_hits
from repro_torch.core.state import DicsState
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ref import similarity_matrix

__all__ = ["DicsHyper", "similarity_matrix", "dics_scores",
           "dics_worker_step", "bucket_start_scores", "make_cuda_worker",
           "dics_partial_topn"]


class DicsHyper(NamedTuple):
    k_nn: int = 10      # neighbourhood size in Eq. 7
    top_n: int = 10     # recommendation list size
    u_cap: int = 512
    i_cap: int = 512
    n_i: int = 1        # item splits (for slot mapping)
    g: int = 1          # user groups


def dics_scores(co, item_cnt, rated_rows, item_ids, k_nn: int):
    """Eq. 7 scores of every local candidate (``dics.py:56``).

    rated_rows bool[W, R, I] -> f32[W, R, I]; ``-inf`` on empty slots and
    rated items.
    """
    sim = similarity_matrix(co, item_cnt)
    mass = ref.neighbour_mass(sim, rated_rows, k_nn)
    valid = (item_ids >= 0)[:, None, :] & ~rated_rows
    return torch.where(valid, mass, float("-inf"))


def _hits(scores, i_slots, known_i, top_n: int):
    """``lax.top_k``-order rank count at the target slot, and its score
    strictly positive (``dics.py:186-193``, ``:261-265``)."""
    s_t = scores.gather(2, i_slots[..., None].long())[..., 0]
    return bucket_start_hits(scores, i_slots, known_i, top_n) & (s_t > 0)


def dics_worker_step(state: DicsState, events, hyper: DicsHyper):
    """Process one micro-batch of buckets on every worker, eagerly.

    Args:
      state: stacked ``DicsState`` ``[W, ...]``, updated in place.
      events: ``(u_ids, i_ids)`` int32 ``[W, capacity]``, ``-1`` padding.

    Returns ``(state, hits, evaluated)`` with bool ``[W, capacity]``.
    """
    ev_u, ev_i = events
    live = (ev_u >= 0).any()
    t = state.tables
    tabs = tuple(t)
    n_w, cap = ev_u.shape
    w = torch.arange(n_w, device=ev_u.device)
    hits = torch.zeros((n_w, cap), dtype=torch.bool, device=ev_u.device)
    for e in range(cap):
        u_id, i_id = ev_u[:, e], ev_i[:, e]
        valid = u_id >= 0
        us = state_lib.slot_of(u_id, hyper.g, hyper.u_cap).long()
        si = state_lib.slot_of(i_id, hyper.n_i, hyper.i_cap).long()
        new_u, new_i = ref.dics_clear(state.co, state.item_cnt, state.rated,
                                      tabs, w, u_id, i_id, us, si, live)
        # --- recommend, then evaluate, on the live statistics ---
        scores = dics_scores(state.co, state.item_cnt,
                             state.rated[w, us][:, None], t.item_ids,
                             hyper.k_nn)
        hits[:, e] = _hits(scores, si[:, None], (valid & ~new_i)[:, None],
                           hyper.top_n)[:, 0]
        # --- incremental Eq. 6 statistics ---
        ref.dics_write(state.co, state.item_cnt, state.rated, tabs, w, u_id,
                       i_id, us, si, new_u, new_i)
    return state, hits, ev_u >= 0


def bucket_start_scores(st: DicsState, ev_u, hyper: DicsHyper):
    """Eq. 7 scores f32[W, E, I] of every bucket slot against the
    bucket-start statistics (``dics.py:244-258``): Eq. 6 once, then the
    dense restriction to each known user's history, in row chunks."""
    t = st.tables
    us = state_lib.slot_of(ev_u, hyper.g, hyper.u_cap).long()
    known_u = t.user_ids.gather(1, us) == ev_u
    w = torch.arange(ev_u.shape[0], device=ev_u.device)[:, None]
    rated_rows = st.rated[w, us] & known_u[..., None]
    return dics_scores(st.co, st.item_cnt, rated_rows, t.item_ids,
                       hyper.k_nn)


def make_cuda_worker(hyper: DicsHyper):
    """DICS worker step on the kernels (``dics.py:218``).

    Every bucket slot is scored against the bucket-start statistics
    (``bucket_start_scores``), the hit bits are rank counts at the target
    slot, then one ``ops.dics_update`` launch applies every worker's
    events in order. Returns ``step(state, (ev_u, ev_i)) -> (state, hits,
    evaluated)`` like ``dics_worker_step``.
    """
    def step(st: DicsState, events):
        ev_u, ev_i = events
        valid = ev_u >= 0
        t = st.tables
        u_slot = state_lib.slot_of(ev_u, hyper.g, hyper.u_cap)
        i_slot = state_lib.slot_of(ev_i, hyper.n_i, hyper.i_cap)
        known_i = t.item_ids.gather(1, i_slot.long()) == ev_i

        # --- recommend (Eq. 6 once per bucket, Eq. 7 batched) ---
        scores = bucket_start_scores(st, ev_u, hyper)
        hits = _hits(scores, i_slot, known_i & valid, hyper.top_n)

        # --- update (one launch: exact reference semantics) ---
        ops.dics_update(st.co, st.item_cnt, st.rated, tuple(t),
                        (ev_u, ev_i, u_slot, i_slot), live=valid.any())
        return st, hits, valid

    return step


def dics_partial_topn(states: DicsState, user_ids, *, top_n: int = 10,
                      k_nn: int = 10, g: int = 1, u_cap: int = 1024,
                      use_kernel: bool = True, storage=None):
    """Every worker's partial DICS top-N over its item split
    (``dics.py:76``).

    Args:
      states: stacked ``DicsState`` ``[W, ...]``.
      user_ids: int32 ``[W, B]`` global user ids, one query row per worker.
      use_kernel: one ``ops.dics_topn`` launch; False runs the plain
        version (``ref.dics_topn``).
      storage: the ``StoragePolicy`` the states are resident under: a
        quantized or bf16 ``co`` is decoded to f32 once per call, a packed
        ``rated`` only in the gathered query rows (``dics.py:101-111``).

    Returns (item_ids i32[W, B, N], scores f32[W, B, N], known bool[W, B]);
    non-candidates (no positive neighbour mass) carry score ``-inf``.
    """
    t = states.tables
    slots = state_lib.slot_of(user_ids, g, u_cap).long()
    known = t.user_ids.gather(1, slots) == user_ids
    hist = storage_lib.gather_rated(states.rated, slots, storage,
                                    t.item_ids.shape[-1]) & known[..., None]
    co = (states.co if storage is None
          else storage_lib.decode_co(states.co, states.co_scale, storage))
    fn = ops.dics_topn if use_kernel else ref.dics_topn
    top_ids, top_scores = fn(co, states.item_cnt, hist, known,
                             t.item_ids, top_n=top_n, k_nn=k_nn)
    return top_ids, top_scores, known
