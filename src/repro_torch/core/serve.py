"""Worker-level recommendation serving: batched top-N queries.

Port of ``repro/core/serve.py``: ``_gather_queries`` (:43),
``partial_topn`` (:63) and ``recommend_topn`` (:104), batched over a
leading worker axis so one kernel launch serves every worker. Lists are
ordered (score desc, global id asc), so a grid merge of partial lists
equals the single-worker list whenever there is one split. Under a
storage policy (``storage=``) only the gathered query rows are decoded
(bf16 user vectors, packed ``rated`` rows) and the item vectors are
taken in f32 (``storage.factor_f32``): K3 gets the same dense mask and
f32 inputs as under the default policy.
"""

from __future__ import annotations

import torch

from repro_torch.core import state as state_lib
from repro_torch.core import storage as storage_lib
from repro_torch.core.state import DisgdState
from repro_torch.kernels import ops

__all__ = ["partial_topn", "recommend_topn"]


def _gather_queries(states: DisgdState, user_ids, g: int, u_cap: int,
                    storage=None):
    """Query vectors, candidate masks and known flags: user_ids [W, B].
    Lazy decode: under a storage policy only the gathered rows are."""
    slots = state_lib.slot_of(user_ids, g, u_cap).long()
    known = states.tables.user_ids.gather(1, slots) == user_ids
    w = torch.arange(user_ids.shape[0], device=user_ids.device)[:, None]
    u_rows = storage_lib.factor_f32(states.user_vecs[w, slots])
    u_vecs = torch.where(known[..., None], u_rows, 0.0)
    rated = storage_lib.gather_rated(
        states.rated, slots, storage,
        states.tables.item_ids.shape[-1]) & known[..., None]
    valid_items = states.tables.item_ids >= 0
    mask = valid_items[:, None, :] & ~rated & known[..., None]
    return u_vecs, mask, known


def partial_topn(states: DisgdState, user_ids, *, top_n: int = 10,
                 g: int = 1, u_cap: int = 1024, use_kernel: bool = True,
                 storage=None):
    """Every worker's partial top-N over its local item split.

    Args:
      states: stacked ``DisgdState`` ``[W, ...]``.
      user_ids: int32 ``[W, B]`` global user ids, one query row per worker.
      use_kernel: score and select with ``ops.fused_topn`` (one launch);
        False runs the plain scoring + ``topn_select``.
      storage: the ``StoragePolicy`` the states are resident under (None
        = compute form).

    Returns (item_ids i32[W, B, N], scores f32[W, B, N], known bool[W, B]);
    non-candidates carry score ``-inf``, so callers mask ids wherever
    scores are not finite.
    """
    u_vecs, mask, known = _gather_queries(states, user_ids, g, u_cap,
                                          storage)
    item_ids = states.tables.item_ids
    item_vecs = storage_lib.factor_f32(states.item_vecs)
    if use_kernel:
        top_ids, top_scores = ops.fused_topn(u_vecs, item_vecs, mask,
                                             item_ids, top_n=top_n)
    else:
        scores = torch.bmm(u_vecs, item_vecs.transpose(1, 2))
        scores = scores.masked_fill(~mask, float("-inf"))
        top_ids, top_scores = ops.topn_select(
            scores, item_ids[:, None, :].expand(scores.shape), top_n)
    return top_ids, top_scores, known


def recommend_topn(state: DisgdState, user_ids, *, top_n: int = 10,
                   g: int = 1, u_cap: int = 1024, use_kernel: bool = True,
                   storage=None):
    """Top-N item ids for a batch of users on ONE worker (unstacked state).

    Returns (item_ids int32[B, N] (-1 padded), scores f32[B, N]): queries
    without an answer get all ``-1`` ids and ``-inf`` scores.
    """
    one = DisgdState(
        tables=type(state.tables)(*(x[None] for x in state.tables)),
        user_vecs=state.user_vecs[None], item_vecs=state.item_vecs[None],
        rated=state.rated[None])
    ids, scores, known = partial_topn(one, user_ids[None], top_n=top_n, g=g,
                                      u_cap=u_cap, use_kernel=use_kernel,
                                      storage=storage)
    ids, scores, known = ids[0], scores[0], known[0]
    ok = torch.isfinite(scores) & known[:, None]
    return (torch.where(ok, ids, -1),
            torch.where(ok, scores, float("-inf")))
