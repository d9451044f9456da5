"""Plain PyTorch versions of the hand-written kernels.

Each function is the semantic ground truth of one CUDA kernel in
``csrc/`` and the port of one oracle in ``repro/kernels/ref.py`` /
``repro/kernels/ops.py``. ``ops.py`` routes CPU tensors here; on the card
``chip_smoke.py`` holds each kernel against these. The recommender's
functions take a leading worker axis ``[n_c, ...]``: their kernels run
every worker in one launch. ``isgd_apply`` (one table pair, no worker
axis) and ``swa_attention`` keep the JAX signatures.
"""

from __future__ import annotations

import torch

__all__ = ["masked_scores", "isgd_apply", "factor_apply", "topn_select",
           "fused_topn", "similarity_matrix", "neighbour_mass", "dics_clear",
           "dics_write", "dics_apply", "dics_topn", "swa_attention",
           "swa_tile_classes", "SWA_SKIPPED", "SWA_FULL", "SWA_BOUNDARY"]

# Elements of the largest dense [rows, I, I] intermediate of
# ``neighbour_mass`` (f32: 256 MB); rows are taken in chunks below it.
_MASS_CHUNK = 1 << 26


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


def isgd_apply(user_tab, item_tab, u_slots, i_slots, valid, *, eta: float,
               lam: float):
    """Sequential factors-only ISGD micro-batch, IN PLACE
    (``repro/kernels/ref.py:34``; paper Eqs. 3/4, ``err = 1 - u.i``).

    user_tab f32[U, k]; item_tab f32[I, k]; u_slots / i_slots i32[E];
    valid bool[E]. Events run in order, each reading the rows the previous
    ones wrote; an invalid event changes nothing, nor does one whose slot
    lies outside its table. Returns the (mutated) ``(user_tab, item_tab)``.

    Out-of-range slots fall outside the parity contract with
    ``repro.kernels.ops.isgd_update``: there a negative slot wraps to the
    last row, and a slot past the end has its gather clamped to the last
    row and its scatter dropped; here (and in the kernel) the event is
    skipped.
    """
    u_slots, i_slots = u_slots.long(), i_slots.long()
    inside = ((u_slots >= 0) & (u_slots < user_tab.shape[0])
              & (i_slots >= 0) & (i_slots < item_tab.shape[0]))
    valid = valid.bool() & inside
    u_slots = torch.where(inside, u_slots, 0)
    i_slots = torch.where(inside, i_slots, 0)
    for e in range(u_slots.shape[0]):
        us, is_ = u_slots[e:e + 1], i_slots[e:e + 1]
        v = valid[e:e + 1, None]
        u, i = user_tab[us], item_tab[is_]
        err = 1.0 - (u * i).sum(-1, keepdim=True)
        u_new = u + eta * (err * i - lam * u)
        i_new = i + eta * (err * u - lam * i)
        user_tab[us] = torch.where(v, u_new, u)
        item_tab[is_] = torch.where(v, i_new, i)
    return user_tab, item_tab


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


# -- DICS (Eq. 6 / Eq. 7) ----------------------------------------------------
#
# Two numerics rules make these bit-identical to the JAX package on the CPU
# (and to the CUDA kernels, which use IEEE sqrtf and division):
#   * the Eq. 6 square root is taken in f64 of the f32 product and rounded
#     once to f32 (PyTorch's vectorised f32 sqrt on the CPU is off by an ulp
#     on some inputs; correctly rounded, it equals XLA's and CUDA's sqrtf);
#   * the top-k_nn neighbour mass is summed left to right over the values in
#     descending order, as XLA reduces ten values and as the kernels add
#     them (``torch.sum`` reorders).


def similarity_matrix(co, item_cnt):
    """Eq. 6 cosine similarity of every local item pair, diagonal 0
    (``repro/core/dics.py:48``): co f32[W, I, I], item_cnt f32[W, I]."""
    prod = item_cnt[:, :, None] * item_cnt[:, None, :]
    denom = torch.sqrt(prod.double()).float()
    sim = torch.where(denom > 0, co / denom.clamp(min=1e-12), 0.0)
    return sim * (1.0 - torch.eye(co.shape[-1], dtype=co.dtype,
                                  device=co.device))


def neighbour_mass(sim, hist, k_nn: int):
    """Eq. 7 top-``k_nn`` neighbour mass (``repro/core/dics.py:56``).

    For every history row ``h = hist[w, r]`` and candidate ``p``: the sum,
    in descending order, of the ``min(k_nn, I)`` largest of
    ``sim[w, p, q]`` over ``q`` in ``h`` (0 elsewhere). sim f32[W, I, I],
    hist bool[W, R, I] -> f32[W, R, I]. The dense [W, rows, I, I]
    restriction is taken in chunks of rows to bound memory.
    """
    n_w, n_r, i = hist.shape
    k = min(k_nn, i)
    top = torch.empty((n_w, n_r, i, k), dtype=sim.dtype, device=sim.device)
    step = max(1, _MASS_CHUNK // max(1, n_w * i * i))
    for r0 in range(0, n_r, step):
        h = hist[:, r0:r0 + step, None, :]
        top[:, r0:r0 + step] = torch.topk(
            torch.where(h, sim[:, None], 0.0), k, dim=-1).values
    acc = top[..., 0]
    for j in range(1, k):
        acc = acc + top[..., j]
    return acc


def dics_clear(co, item_cnt, rated, tabs, w, u_id, i_id, us, is_,
               live=None):
    """First half of one DICS event on every worker, IN PLACE: the
    collision-eviction clears, from the raw slot compare and NOT gated on
    the event's validity (``repro/kernels/ref.py:177-183``): a padding
    event (id -1, slot ``cap - 1``) clears a live last slot. ``live``
    (0-d bool) gates them all: False in a step without events, which the
    JAX engine skips. Returns ``(new_u, new_i)``."""
    uid, iid = tabs[0], tabs[1]
    new_u = uid[w, us] != u_id
    new_i = iid[w, is_] != i_id
    clear_u, clear_i = new_u, new_i
    if live is not None:
        clear_u, clear_i = new_u & live, new_i & live
    rated[w, us] = rated[w, us] & ~clear_u[:, None]
    rated[w, :, is_] = rated[w, :, is_] & ~clear_i[:, None]
    co[w, is_] = torch.where(clear_i[:, None], 0.0, co[w, is_])
    co[w, :, is_] = torch.where(clear_i[:, None], 0.0, co[w, :, is_])
    item_cnt[w, is_] = torch.where(clear_i, 0.0, item_cnt[w, is_])
    return new_u, new_i


def dics_write(co, item_cnt, rated, tabs, w, u_id, i_id, us, is_, new_u,
               new_i):
    """Second half of one DICS event, IN PLACE, for valid events only:
    the user's history (read after the clears) into the ``co`` row, then
    into the column (which reads the row-updated diagonal, so ``co[i, i]``
    gains ``hist[i]`` twice), ``item_cnt[i] += 1``, the bookkeeping, and
    ``rated[u, i]``."""
    uid, iid, ufq, ifq, uts, its, clock = tabs
    valid = u_id >= 0
    vcol = valid[:, None]
    hist = rated[w, us].to(co.dtype)
    co[w, is_] = torch.where(vcol, co[w, is_] + hist, co[w, is_])
    co[w, :, is_] = torch.where(vcol, co[w, :, is_] + hist, co[w, :, is_])
    item_cnt[w, is_] = torch.where(valid, item_cnt[w, is_] + 1.0,
                                   item_cnt[w, is_])
    clock += valid.to(clock.dtype)
    ufq[w, us] = torch.where(valid, torch.where(new_u, 1, ufq[w, us] + 1),
                             ufq[w, us])
    ifq[w, is_] = torch.where(valid, torch.where(new_i, 1, ifq[w, is_] + 1),
                              ifq[w, is_])
    uid[w, us] = torch.where(valid, u_id, uid[w, us])
    iid[w, is_] = torch.where(valid, i_id, iid[w, is_])
    uts[w, us] = torch.where(valid, clock, uts[w, us])
    its[w, is_] = torch.where(valid, clock, its[w, is_])
    rated[w, us, is_] |= valid


def dics_apply(co, item_cnt, rated, tabs, events, live=None):
    """Sequential DICS micro-batch update, IN PLACE
    (``repro/kernels/ref.py:153``): per event, ``dics_clear`` then
    ``dics_write``.

    Args:
      co / item_cnt / rated: f32[W, I, I] / f32[W, I] / bool[W, U, I].
      tabs: as ``factor_apply``.
      events: ``(ev_u, ev_i, u_slots, i_slots)``, i32 ``[W, E]``.
      live: optional 0-d bool; False makes the call change nothing.

    Returns the (mutated) ``(co, item_cnt, rated, tabs)``.
    """
    ev_u, ev_i, u_slots, i_slots = events
    if live is not None:   # not live: every event is padding, clears gated
        ev_u = torch.where(live, ev_u, -1)
    w = torch.arange(ev_u.shape[0], device=ev_u.device)
    for e in range(ev_u.shape[1]):
        u_id, i_id = ev_u[:, e], ev_i[:, e]
        us, is_ = u_slots[:, e].long(), i_slots[:, e].long()
        new_u, new_i = dics_clear(co, item_cnt, rated, tabs, w, u_id, i_id,
                                  us, is_, live)
        dics_write(co, item_cnt, rated, tabs, w, u_id, i_id, us, is_, new_u,
                   new_i)
    return co, item_cnt, rated, tabs


def dics_topn(co, item_cnt, hist, known, item_ids, top_n: int, k_nn: int):
    """DICS serve leaf (the jnp path of ``repro/core/dics.py:120-131``):
    Eq. 6 similarity, Eq. 7 neighbour mass over the query's history, the
    candidate rule (live slot, unrated, known user, mass > 0), then
    ``topn_select``. Non-candidates surface at ``-inf`` with their ids.

    co f32[W, I, I]; item_cnt f32[W, I]; hist bool[W, B, I] (known-masked
    rated rows); known bool[W, B]; item_ids i32[W, I]. Returns (ids
    i32[W, B, n], scores f32[W, B, n]), ``n = min(top_n, I)``.
    """
    mass = neighbour_mass(similarity_matrix(co, item_cnt), hist, k_nn)
    cand = ((item_ids >= 0)[:, None, :] & ~hist & known[..., None]
            & (mass > 0))
    scores = torch.where(cand, mass, float("-inf"))
    return topn_select(scores, item_ids[:, None, :].expand(scores.shape),
                       top_n)


# -- LM zoo --------------------------------------------------------------------


def swa_attention(q, k, v, *, window: int | None, causal: bool = True):
    """Sliding-window (or full causal) attention (``repro/kernels/ref.py:207``).

    q [B, Hq, S, D]; k, v [B, Hkv, S, D] with ``Hq % Hkv == 0`` (GQA: q
    head ``h`` reads kv head ``h // (Hq / Hkv)``); ``window``: attend to
    keys in ``(pos - window, pos]``, None = unbounded; ``causal=False``
    drops the upper bound. Logits, softmax and ``p @ v`` in f32, scaled by
    ``1 / sqrt(D)``; the result in q's type. A row with no visible key
    gives 0, as the flash kernels give it (the JAX oracle gives NaN).
    """
    _, hq, s, d = q.shape
    group = hq // k.shape[1]
    kr = k.repeat_interleave(group, dim=1)
    vr = v.repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) \
        / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    m = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        m &= ki <= qi
    if window is not None:
        m &= ki > qi - window
    p = torch.softmax(logits.masked_fill_(~m, float("-inf")), dim=-1)
    p = torch.where(m.any(-1, keepdim=True), p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr.float()).to(q.dtype)


SWA_SKIPPED, SWA_FULL, SWA_BOUNDARY = 0, 1, 2


def swa_tile_classes(s: int, window: int | None, causal: bool = True,
                     bq: int = 128, bk: int = 128) -> torch.Tensor:
    """The bf16 ``swa_attention`` kernel's rule for which kv tiles a q
    block visits and which of them it masks (``csrc/swa_attention.cu``,
    ``tile_range`` and ``tile_full``), for the CPU tests.

    Returns int8 [ceil(s / bq), ceil(s / bk)]: ``SWA_SKIPPED`` for a tile
    the block never loads, ``SWA_FULL`` for a visited tile whose every
    (row, key) pair is visible (no mask runs), ``SWA_BOUNDARY`` for the
    other visited tiles (the per-logit mask and the no-visible-key guard
    run). A block visits the tiles from its rows' first visible key to
    their last.
    """
    out = torch.full((-(-s // bq), -(-s // bk)), SWA_SKIPPED,
                     dtype=torch.int8)
    for qb in range(out.shape[0]):
        q0 = qb * bq
        q1 = min(q0 + bq, s) - 1
        last = min(q1, s - 1) if causal else s - 1
        first = 0 if window is None else max(0, q0 - window + 1)
        if last < first:
            continue
        for kt in range(first // bk, last // bk + 1):
            k0 = kt * bk
            full = (k0 + bk - 1 < s and (not causal or k0 + bk - 1 <= q0)
                    and (window is None or k0 > q1 - window))
            out[qb, kt] = SWA_FULL if full else SWA_BOUNDARY
    return out
