"""Plain PyTorch versions of the hand-written kernels.

Each function is the semantic ground truth of one CUDA kernel in
``csrc/`` and the port of one oracle in ``repro/kernels/ref.py`` /
``repro/kernels/ops.py``. ``ops.py`` routes CPU tensors here; on the card
``chip_smoke.py`` holds each kernel against these. All take a leading
worker axis ``[n_c, ...]``: the kernels run every worker in one launch.
"""

from __future__ import annotations

import torch

__all__ = ["masked_scores", "factor_apply", "topn_select", "fused_topn"]


def masked_scores(u_vecs, item_vecs, mask):
    """Masked recommendation scoring (``repro/kernels/ref.py:16``).

    Args:
      u_vecs: f32[W, B, k] query vectors per worker.
      item_vecs: f32[W, I, k] each worker's local item table.
      mask: bool or uint8 [W, B, I], nonzero where the item is a candidate.

    Returns f32[W, B, I] scores, ``-inf`` where masked.
    """
    scores = torch.bmm(u_vecs.float(), item_vecs.float().transpose(1, 2))
    return scores.masked_fill(~mask.bool(), float("-inf"))


def factor_apply(user_vecs, item_vecs, rated, tabs, events, *, eta: float,
                 lam: float):
    """Sequential factor-model micro-batch update, IN PLACE
    (``repro/kernels/ref.py:59``): the complete worker transition per
    event — init-or-gather, ISGD or pairwise-BPR step, collision
    eviction on ``rated``, freq/id/ts/clock bookkeeping.

    Args:
      user_vecs / item_vecs / rated: f32[W, U, k] / f32[W, I, k] /
        bool[W, U, I].
      tabs: ``(user_ids, item_ids, user_freq, item_freq, user_ts,
        item_ts, clock)``, i32 ``[W, U]``/``[W, I]`` and clock ``[W]``.
      events: ``(ev_u, ev_i, u_slots, i_slots, j_slots, init_u, init_i)``
        with i32 ``[W, E]`` ids/slots (``-1`` ids are padding, which
        touches nothing), ``j_slots`` ``None`` for ISGD or pre-sampled
        negative slots for BPR, and f32 ``[W, E, k]`` init vectors.

    Events run in order within a worker; workers are independent.
    Returns the (mutated) ``(user_vecs, item_vecs, rated, tabs)``.
    """
    uid, iid, ufq, ifq, uts, its, clock = tabs
    ev_u, ev_i, u_slots, i_slots, j_slots, init_u, init_i = events
    pairwise = j_slots is not None
    w = torch.arange(ev_u.shape[0], device=ev_u.device)
    for e in range(ev_u.shape[1]):
        u_id, i_id = ev_u[:, e], ev_i[:, e]
        us, is_ = u_slots[:, e].long(), i_slots[:, e].long()
        valid = u_id >= 0
        new_u = uid[w, us] != u_id
        new_i = iid[w, is_] != i_id
        u_vec = torch.where(new_u[:, None], init_u[:, e], user_vecs[w, us])
        i_vec = torch.where(new_i[:, None], init_i[:, e], item_vecs[w, is_])
        if pairwise:
            js = j_slots[:, e].long()
            rated_row = rated[w, us] & ~new_u[:, None]
            rated_row[w, is_] &= ~new_i
            neg_id = iid[w, js]
            neg_ok = ((neg_id >= 0) & (neg_id != i_id) & (js != is_)
                      & ~rated_row[w, js])
            upd = (valid & neg_ok)[:, None]
            j_vec = item_vecs[w, js]
            x = (u_vec * i_vec).sum(-1) - (u_vec * j_vec).sum(-1)
            s = torch.sigmoid(-x)[:, None]
            u_new = torch.where(
                upd, u_vec + eta * (s * (i_vec - j_vec) - lam * u_vec), u_vec)
            i_new = torch.where(
                upd, i_vec + eta * (s * u_vec - lam * i_vec), i_vec)
            j_new = j_vec + eta * (-s * u_vec - lam * j_vec)
            # j before i: when the update is skipped and js aliases is_,
            # this writes j_vec back unchanged and i's write below wins.
            item_vecs[w, js] = torch.where(upd, j_new, j_vec)
        else:
            err = 1.0 - (u_vec * i_vec).sum(-1, keepdim=True)
            u_new = u_vec + eta * (err * i_vec - lam * u_vec)
            i_new = i_vec + eta * (err * u_vec - lam * i_vec)

        vcol = valid[:, None]
        clock += valid.to(clock.dtype)
        ufq[w, us] = torch.where(valid, torch.where(new_u, 1, ufq[w, us] + 1),
                                 ufq[w, us])
        ifq[w, is_] = torch.where(valid,
                                  torch.where(new_i, 1, ifq[w, is_] + 1),
                                  ifq[w, is_])
        uid[w, us] = torch.where(valid, u_id, uid[w, us])
        iid[w, is_] = torch.where(valid, i_id, iid[w, is_])
        uts[w, us] = torch.where(valid, clock, uts[w, us])
        its[w, is_] = torch.where(valid, clock, its[w, is_])
        # Eviction order: clear the evicted item's column, then read the
        # user's row (cleared if the user is new), then mark (u, i).
        rated[w, :, is_] = rated[w, :, is_] & ~(valid & new_i)[:, None]
        row = rated[w, us] & ~(valid & new_u)[:, None]
        row[w, is_] |= valid
        rated[w, us] = row
        user_vecs[w, us] = torch.where(vcol, u_new, user_vecs[w, us])
        item_vecs[w, is_] = torch.where(vcol, i_new, item_vecs[w, is_])
    return user_vecs, item_vecs, rated, tabs


def topn_select(scores, ids, top_n: int):
    """Deterministic top-N over the last axis (``repro/kernels/ops.py:231``).

    Order is (score descending, global id ascending). ``jnp.lexsort((ids,
    -scores))`` becomes two stable sorts: by id, then by ``-score``.
    Returns ``(ids, scores)`` of ``min(top_n, C)`` columns.
    """
    n = min(top_n, scores.shape[-1])
    by_id = torch.sort(ids, dim=-1, stable=True).indices
    by_score = torch.sort(-torch.gather(scores, -1, by_id), dim=-1,
                          stable=True).indices
    order = torch.gather(by_id, -1, by_score)[..., :n]
    return torch.gather(ids, -1, order), torch.gather(scores, -1, order)


def fused_topn(u_vecs, item_vecs, mask, item_ids, top_n: int):
    """Serve leaf (``repro/kernels/ops.py:158`` off TPU): masked scores,
    then ``topn_select`` over each worker's ``item_ids`` (i32[W, I]).
    Non-candidates surface at ``-inf`` with their real ids."""
    scores = masked_scores(u_vecs, item_vecs, mask)
    ids = item_ids[:, None, :].expand(scores.shape)
    return topn_select(scores, ids, top_n)
