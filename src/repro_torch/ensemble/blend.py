"""Serve-plane rank fusion of per-member top-N lists.

Port of ``repro/ensemble/blend.py``, NumPy on the host: the fused sums
add float64 contributions per item in the fixed member order, so every
fused list and score equals the JAX package's bit for bit (an
unordered scatter-add on the card would reorder ties).

Each ensemble member serves its own grid-wide top-N through its own
``SnapshotStore`` + ``QueryFrontend`` (the serve plane is reused, never
forked). This module merges those lists into one answer per query row:

  * ``"rrf"`` — weighted reciprocal-rank fusion: item scores sum
    ``w_m / (rrf_k + rank + 1)`` over the members that ranked it;
  * ``"borda"`` — weighted Borda count: ``w_m * (N - rank)``.

Both are *rank*-based on purpose: member score scales are incomparable
(DISGD dot products vs DICS co-occurrence ratios), ranks are not.

Fusion is deterministic: members contribute in a fixed (name-sorted)
order, and the fused list is ordered by the same tie-break contract as
the single-model serve plane — fused score descending, then global item
id ascending. ``"switch"`` mode skips fusion entirely and routes each
query to the argmax-weight member (ties broken by member-name order).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

__all__ = ["BlendPolicy", "fuse_topn", "switch_choice"]


class BlendPolicy(NamedTuple):
    """How the ensemble turns member lists into one answer."""

    mode: str = "blend"    # "blend" (rank fusion) | "switch" (argmax member)
    method: str = "rrf"    # "rrf" | "borda" fusion score
    rrf_k: int = 60        # RRF dampening constant


def _contribution(method: str, rank: np.ndarray, n: int,
                  rrf_k: int) -> np.ndarray:
    if method == "rrf":
        return 1.0 / (rrf_k + rank + 1)
    if method == "borda":
        return (n - rank).astype(np.float64)
    raise ValueError(f"unknown fusion method {method!r}")


def fuse_topn(member_ids: Sequence[np.ndarray],
              member_scores: Sequence[np.ndarray],
              member_known: Sequence[np.ndarray],
              weights: np.ndarray, *, top_n: int,
              method: str = "rrf", rrf_k: int = 60):
    """Weighted rank fusion of per-member top-N lists, one query batch.

    ``member_ids`` / ``member_scores``: per member (fixed order),
    ``[Q, N]`` arrays, ids −1-padded; ``member_known``: per member
    ``bool[Q]`` — fallback (unknown-user) rows contribute nothing to the
    fusion. ``weights``: ``f32[Q, M]`` per-row member weights.

    Returns ``(ids i32[Q, top_n], scores f32[Q, top_n], known bool[Q])``
    with rows sorted by (fused score desc, id asc) and −1/0 padding; a
    row is ``known`` when at least one member knew the user.
    """
    m = len(member_ids)
    q = member_ids[0].shape[0] if m else 0
    weights = np.asarray(weights, np.float64).reshape(q, m)
    out_ids = np.full((q, top_n), -1, np.int32)
    out_scores = np.zeros((q, top_n), np.float32)
    known = np.zeros((q,), bool)

    for row in range(q):
        fused: dict[int, float] = {}
        for mi in range(m):
            if not bool(member_known[mi][row]) or weights[row, mi] <= 0:
                continue
            known[row] = True
            ids = np.asarray(member_ids[mi][row])
            live = ids >= 0
            if not live.any():
                continue
            rank = np.flatnonzero(live)
            contrib = weights[row, mi] * _contribution(
                method, np.arange(rank.size), ids.shape[0], rrf_k)
            for iid, c in zip(ids[rank], contrib):
                fused[int(iid)] = fused.get(int(iid), 0.0) + float(c)
        if not fused:
            continue
        cand = np.fromiter(fused.keys(), np.int64, len(fused))
        score = np.fromiter(fused.values(), np.float64, len(fused))
        # The serve plane's tie-break contract: score desc, then id asc.
        order = np.lexsort((cand, -score))[:top_n]
        out_ids[row, :order.size] = cand[order]
        out_scores[row, :order.size] = score[order]
    return out_ids, out_scores, known


def switch_choice(weights_row: np.ndarray,
                  names: Sequence[str]) -> int:
    """Hard-switch routing: index of the argmax-weight member.

    Ties break by member-name ascending — the same fixed member order
    fusion uses — so routing is deterministic across runs and member
    registration order.
    """
    w = np.asarray(weights_row, np.float64).reshape(-1)
    return min(range(len(names)), key=lambda i: (-w[i], names[i]))
