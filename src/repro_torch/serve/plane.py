"""Grid-wide top-N query plane: fan-out + cross-split merge, on the device.

Port of ``repro/serve/plane.py``: ``query_capacity`` (:38) and
``grid_topn`` (:52). A query for user ``u`` concerns the ``n_i`` workers
of ``u``'s grid column; each scores its own item split, and the partial
lists merge across the split axis with ``ops.topn_merge`` in (score
desc, global id asc) order — independent of slot layout and of the order
of the splits.

Queries are bucketed by column (the training plane's dispatch), every
worker scores its column's bucket in ONE kernel launch over all ``n_c``
workers (``fused_topn`` for DISGD, ``dics_topn`` for DICS, as the
registered algorithm's serve leaf chooses), and the merged lists are
scattered back to request order.

On the process grid (``mesh=``, ``backend="shard_map"``) each rank
holds one worker and scores its column's bucket alone, one launch of the
same leaf; one all-gather on the mesh's serve group (the reader's,
``core.distributed.grid_all_gather(group="serve")``) gives
every rank the ``[n_c, qcap, N]`` partial lists and ``known`` flags,
and every rank merges them as one process does. The leaf scores each
worker on its own, so the answer is the one-process answer, bit for
bit, on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import algorithm as algorithm_lib
from repro_torch.core import routing
from repro_torch.kernels import ops

__all__ = ["grid_topn", "query_capacity"]


def query_capacity(batch_size: int, g: int, factor: float = 2.0) -> int:
    """Per-column bucket capacity for a query micro-batch: ``factor``
    times the fair share, floored at 8 and capped at the batch size."""
    fair = batch_size / g
    return max(8, min(batch_size, int(np.ceil(fair * factor))))


def grid_topn(states, user_ids, *, algorithm: str = "disgd",
              grid: routing.GridSpec = routing.GridSpec(1), top_n: int = 10,
              u_cap: int = 1024, qcap: int = 64, k_nn: int = 10,
              use_kernel: bool = True, storage=None, mesh=None):
    """Grid-wide top-N for a batch of users, merged across item splits.

    Args:
      states: stacked worker states ``[n_c, ...]`` (worker key =
        row * g + col), e.g. ``StreamResult.final_states``; with
        ``mesh``, this rank's own worker ``[1, ...]`` (``[0, ...]`` past
        the grid).
      user_ids: int ``[Q]`` global user ids; ``-1`` entries are padding.
      algorithm: registry key (``core/algorithm.py``); its serve leaf
        scores the splits.
      u_cap / k_nn: hyperparameters (``DisgdHyper`` / ``DicsHyper``;
        ``k_nn`` is read by DICS only).
      qcap: per-column query bucket capacity (``query_capacity``).
      use_kernel: serve through the leaf's kernel (one launch per call);
        False runs its plain version.
      storage: the ``StoragePolicy`` the states are resident under (None
        = compute form); the leaf decodes lazily, never a whole table.
      mesh: the process grid's ``launch.mesh.Mesh`` (every rank calls
        with the same ``user_ids``), or None in one process.

    Returns:
      ids i32[Q, N] merged top-N global item ids, -1 padded;
      scores f32[Q, N], -inf where ids == -1;
      known bool[Q]: user known on at least one worker of their column;
      served bool[Q]: False for padding and for column-bucket overflow.
    """
    n_i, g = grid.n_i, grid.g
    q = user_ids.shape[0]
    user_ids = user_ids.to(torch.int32)
    valid = user_ids >= 0
    # Invalid entries route to column g: no capacity, no load.
    col = torch.where(valid, user_ids % g, g)
    buckets, kept, _ = routing.bucket_dispatch(col, g, qcap)   # [g, qcap]
    served = kept & valid
    qu = torch.where(buckets >= 0, user_ids[buckets.clamp(min=0).long()], -1)

    # Worker r * g + c scores column c's bucket against its own split.
    leaf = algorithm_lib.get_algorithm(algorithm).make_serve_leaf(
        top_n=top_n, g=g, u_cap=u_cap, k_nn=k_nn, use_kernel=use_kernel,
        storage=storage)
    if mesh is None:
        p_ids, p_scores, p_known = leaf(states, qu.repeat(n_i, 1))
    else:
        p_ids, p_scores, p_known = _rank_partials(mesh, leaf, states, qu,
                                                  top_n)
    n_part = p_ids.shape[-1]
    # [n_i, g, qcap, N] -> [g, qcap, n_i, N]: merge over the split axis.
    m_ids, m_scores = ops.topn_merge(
        p_ids.reshape(n_i, g, qcap, n_part).permute(1, 2, 0, 3),
        p_scores.reshape(n_i, g, qcap, n_part).permute(1, 2, 0, 3), top_n)
    known = p_known.reshape(n_i, g, qcap).any(0)               # [g, qcap]

    ok = torch.isfinite(m_scores) & known[..., None]
    m_ids = torch.where(ok, m_ids, -1)
    m_scores = torch.where(ok, m_scores, float("-inf"))

    # Scatter bucket-ordered results back to request order; bucket
    # padding lands in a dump row past the end.
    n = m_ids.shape[-1]
    flat = buckets.reshape(-1).long()
    tgt = torch.where(flat >= 0, flat, q)
    dev = user_ids.device
    out_ids = torch.full((q + 1, n), -1, dtype=torch.int32, device=dev)
    out_scores = torch.full((q + 1, n), float("-inf"), device=dev)
    out_known = torch.zeros((q + 1,), dtype=torch.bool, device=dev)
    out_ids[tgt] = m_ids.reshape(-1, n)
    out_scores[tgt] = m_scores.reshape(-1, n)
    out_known[tgt] = known.reshape(-1)
    return out_ids[:q], out_scores[:q], out_known[:q] & valid, served


def _rank_partials(mesh, leaf, states, qu, top_n: int):
    """The grid's partial lists from this rank's worker: the leaf on its
    column's bucket (``w % g``), then one all-gather. A rank past the
    grid adds empty rows."""
    from repro_torch.core import distributed

    g, qcap = qu.shape
    if mesh.holds_worker:
        col = (mesh.rank or 0) % g
        rows = leaf(states, qu[col:col + 1])
    else:       # the leaf's list width: min(top_n, i_cap)
        n = min(top_n, states.tables.item_ids.shape[-1])
        dev = qu.device
        rows = (torch.empty((0, qcap, n), dtype=torch.int32, device=dev),
                torch.empty((0, qcap, n), dtype=torch.float32, device=dev),
                torch.empty((0, qcap), dtype=torch.bool, device=dev))
    return distributed.grid_all_gather(mesh, list(rows), "serve")
