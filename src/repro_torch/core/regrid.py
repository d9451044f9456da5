"""Online (g, n_i) resharding: the elastic-grid transform for S&R state.

Port of ``repro/core/regrid.py``. The transform runs in two halves that
compose into ``regrid``:

  * ``extract_logical`` — flatten every worker's live entries into a
    ``LogicalState``: records keyed by **global** user / item id with
    their replica provenance (the source grid row of a user replica, the
    source column of an item replica), the exact pair-partitioned rating
    relation and the DICS co-occurrence blocks, always in the decoded
    compute form. No target shape appears in it, so it rebuilds at any
    ``(n_i', g')``; it is also the grid-portable checkpoint payload
    (``pipeline.save_stream_checkpoint(grid=...)``).
  * ``build_states`` — scatter the records into freshly shaped tables for
    the target grid (``slot = (id // stride) % capacity``), re-replicate
    user vectors over the new replica rows, re-partition the DICS blocks
    by the new item splits, and encode under a storage policy.

Replica mapping is JAX's congruence rule: destination row ``r'`` merges
the source rows ``r ≡ r' (mod gcd(n_i, n_i'))``, columns likewise with
``gcd(g, g')``. A slot's tenant is the record with the freshest ``ts``,
ties to the lowest record index; every record of the tenant's id (its
co-tenants) adds to ``freq`` and ``cnt`` and maxes ``ts``; vectors merge
by ``merge`` (``"fresh"``: the tenant's verbatim; ``"mean"``: the
frequency-weighted mean of the co-tenants). The identity regrid is
exact, bit for bit.

Two departures from the JAX code, neither visible in the result:

  * flat slot addresses are int64 (JAX's are int32, which wraps past
    2^31 elements: DISGD's deployment ``rated`` has 4.22e9);
  * ``rated`` is rebuilt from its live pairs (``nonzero``, worker by
    worker), not through JAX's dense ``[n_c, u_cap, i_cap]`` index
    temporaries (33.8 GB of int64 at that size). That reads the number
    of pairs on the host: regrid runs between stream segments.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import state as state_lib
from repro_torch.core import storage as storage_lib
from repro_torch.core.routing import GridSpec
from repro_torch.core.state import DicsState, DisgdState, Tables

__all__ = ["LogicalState", "CheckpointShapeError", "extract_logical",
           "build_states", "regrid"]


class CheckpointShapeError(ValueError):
    """A fixed-shape checkpoint does not fit the configured worker grid.

    Carries both shapes. Restore with the grid the checkpoint was written
    at, or re-save it in the grid-portable logical format
    (``save_stream_checkpoint(..., grid=...)``), which restores at any
    ``(n_i, g)``.
    """

    def __init__(self, checkpoint_workers, config_grid: GridSpec,
                 detail: str = ""):
        self.checkpoint_workers = checkpoint_workers
        self.config_grid = config_grid
        msg = (
            f"checkpoint was written for a {checkpoint_workers}-worker grid "
            f"but the config asks for {config_grid} "
            f"(n_c={config_grid.n_c}){': ' + detail if detail else ''}. "
            "Restore with the original grid, or re-save the checkpoint in "
            "the grid-portable logical format (save_stream_checkpoint(..., "
            "grid=...)) which repro.core.regrid rebuilds at any shape."
        )
        super().__init__(msg)


class LogicalState(NamedTuple):
    """Grid-portable worker state: global-id-keyed records + provenance
    (JAX's fields, in JAX's order). Records are flattened worker-major;
    zero-width leaves (``u_vec`` / ``i_vec`` with k = 0, ``co`` with zero
    side) mark the algorithm that does not own them."""

    # user replica records, [n_c * u_cap]
    u_id: torch.Tensor      # i32, global id, -1 = empty slot
    u_row: torch.Tensor     # i32, source grid row of this replica
    u_freq: torch.Tensor    # i32
    u_ts: torch.Tensor      # i32
    u_vec: torch.Tensor     # f32[N, k] (DISGD) / f32[N, 0] (DICS)
    # item replica records, [n_c * i_cap]
    i_id: torch.Tensor      # i32
    i_col: torch.Tensor     # i32, source grid column of this replica
    i_freq: torch.Tensor    # i32
    i_ts: torch.Tensor      # i32
    i_vec: torch.Tensor     # f32[M, k] (DISGD) / f32[M, 0] (DICS)
    i_cnt: torch.Tensor     # f32[M] Eq. 6 denominators (zeros for DISGD)
    # exact pair-partitioned relations, source worker-major
    rated: torch.Tensor     # bool[n_c, u_cap, i_cap]
    co: torch.Tensor        # f32[n_c, i_cap, i_cap] (f32[n_c, 0, 0] DISGD)
    clock: torch.Tensor     # i32[n_i, g] per-worker event clocks


def extract_logical(states, grid: GridSpec, storage=None) -> LogicalState:
    """Flatten stacked ``[n_c, ...]`` worker states into a LogicalState.

    ``storage`` names the policy the states are resident under; the
    logical form is always the decoded compute form (a new tensor for
    every decoded table), so it is policy-portable.
    """
    if storage is not None:
        states = storage_lib.decode_state(states, storage)
    t = states.tables
    n_c, u_cap = t.user_ids.shape
    i_cap = t.item_ids.shape[1]
    if n_c != grid.n_c:
        raise CheckpointShapeError(n_c, grid, "stacked states/grid mismatch")
    dev = t.user_ids.device
    w = torch.arange(n_c, dtype=torch.int32, device=dev)
    u_row = (w // grid.g)[:, None].expand(n_c, u_cap).reshape(-1)
    i_col = (w % grid.g)[:, None].expand(n_c, i_cap).reshape(-1)
    f32 = dict(dtype=torch.float32, device=dev)

    if isinstance(states, DisgdState):
        k = states.user_vecs.shape[-1]
        u_vec = states.user_vecs.reshape(n_c * u_cap, k)
        i_vec = states.item_vecs.reshape(n_c * i_cap, k)
        i_cnt = torch.zeros((n_c * i_cap,), **f32)
        co = torch.zeros((n_c, 0, 0), **f32)
    elif isinstance(states, DicsState):
        u_vec = torch.zeros((n_c * u_cap, 0), **f32)
        i_vec = torch.zeros((n_c * i_cap, 0), **f32)
        i_cnt = states.item_cnt.reshape(n_c * i_cap)
        co = states.co
    else:
        raise TypeError(f"unknown state type {type(states)}")

    return LogicalState(
        u_id=t.user_ids.reshape(-1), u_row=u_row,
        u_freq=t.user_freq.reshape(-1), u_ts=t.user_ts.reshape(-1),
        u_vec=u_vec,
        i_id=t.item_ids.reshape(-1), i_col=i_col,
        i_freq=t.item_freq.reshape(-1), i_ts=t.item_ts.reshape(-1),
        i_vec=i_vec, i_cnt=i_cnt,
        rated=states.rated, co=co,
        clock=t.clock.reshape(grid.n_i, grid.g),
    )


def _tile_records(axis_coord, gcd_ax: int, reps: int):
    """Replicate records to their destination rows / columns: a replica at
    source coordinate ``a`` goes to every ``a' = a % gcd + t * gcd``, ``t
    < reps``. Returns the flattened target coordinates and the index of
    each copy's source record."""
    n = axis_coord.shape[0]
    dev = axis_coord.device
    t = torch.arange(reps, dtype=torch.int32, device=dev)
    coord = (axis_coord % gcd_ax)[None, :] + (t * gcd_ax)[:, None]
    src_idx = torch.arange(n, device=dev).expand(reps, n)
    return coord.reshape(-1), src_idx.reshape(-1)


def _scatter_merge(*, ids, ts, freq, dest, n_slots: int, vec=None, cnt=None,
                   merge: str):
    """Winner-take-slot scatter with replica merging (JAX's rules).

    ``dest`` is each record's int64 flat destination slot. The tenant is
    the record with the highest ``ts``, ties to the lowest record index;
    every record carrying the tenant's id adds to ``freq`` / ``cnt`` and
    maxes ``ts``; vectors merge by ``merge``. Dead records go to a dump
    slot ``n_slots`` that is cut off, as JAX's ``mode="drop"``.
    """
    live = ids >= 0
    dump = torch.full_like(dest, n_slots)
    dest = torch.where(live, dest, dump)
    safe = torch.where(live, dest, 0)
    n = ids.shape[0]
    dev = ids.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)

    def filled(value, dtype, tail=()):
        return torch.full((n_slots + 1,) + tail, value, dtype=dtype,
                          device=dev)

    # Stage 1: the freshest ts per slot; stage 2: the lowest index of it.
    ts_max = filled(-1, ts.dtype).scatter_reduce_(0, dest, ts, "amax")
    tied = live & (ts == ts_max[safe])
    idx_min = filled(n, torch.int64).scatter_reduce_(
        0, torch.where(tied, dest, dump), idx, "amin")
    winner = tied & (idx == idx_min[safe])

    win_dest = torch.where(winner, dest, dump)
    out_ids = filled(-1, ids.dtype)
    out_ids[win_dest] = ids
    coten = live & (ids == out_ids[safe])
    cot_dest = torch.where(coten, dest, dump)

    out_freq = filled(0, freq.dtype).index_add_(0, cot_dest, freq)
    out_ts = filled(0, ts.dtype).scatter_reduce_(0, cot_dest, ts, "amax")

    out_vec = None
    if vec is not None and vec.shape[-1]:
        k = (vec.shape[-1],)
        if merge == "fresh":
            out_vec = filled(0.0, vec.dtype, k)
            out_vec[win_dest] = vec
        elif merge == "mean":
            w = torch.clamp(freq, min=1).to(vec.dtype)
            num = filled(0.0, vec.dtype, k).index_add_(0, cot_dest,
                                                       vec * w[:, None])
            den = filled(0.0, vec.dtype).index_add_(0, cot_dest, w)
            out_vec = num / torch.clamp(den, min=1.0)[:, None]
        else:
            raise ValueError(f"unknown merge policy {merge!r}")
        out_vec = out_vec[:n_slots]
    elif vec is not None:
        out_vec = torch.zeros((n_slots, 0), dtype=vec.dtype, device=dev)

    out_cnt = None
    if cnt is not None:
        out_cnt = filled(0.0, cnt.dtype).index_add_(0, cot_dest,
                                                    cnt)[:n_slots]
    return (out_ids[:n_slots], out_freq[:n_slots], out_ts[:n_slots],
            out_vec, out_cnt)


def _rated_pairs(logical: LogicalState):
    """The live ``(global user, global item)`` pairs of the logical
    relation, worker by worker (each ``nonzero`` under 2^31 elements)."""
    src_nc, s_ucap, s_icap = logical.rated.shape
    u_tab = logical.u_id.reshape(src_nc, s_ucap)
    i_tab = logical.i_id.reshape(src_nc, s_icap)
    us, is_ = [], []
    for w in range(src_nc):
        su, si = logical.rated[w].nonzero(as_tuple=True)
        us.append(u_tab[w][su])
        is_.append(i_tab[w][si])
    return torch.cat(us), torch.cat(is_)


def build_states(logical: LogicalState, *, src: GridSpec, dst: GridSpec,
                 u_cap: int, i_cap: int, merge: str = "fresh", storage=None):
    """Rebuild stacked ``[dst.n_c, ...]`` worker states from a LogicalState.

    ``u_cap`` / ``i_cap`` are the target capacities (a shrink evicts as a
    slot insert would: the freshest tenant wins). The algorithm is carried
    by the leaves (zero-width ``co`` means DISGD). ``storage`` encodes the
    rebuilt states (the target policy when regrid migrates policies).
    """
    is_disgd = logical.co.shape[-1] == 0
    n_c = dst.n_c
    gcd_n = math.gcd(src.n_i, dst.n_i)
    gcd_g = math.gcd(src.g, dst.g)
    dev = logical.u_id.device

    # --- user replicas: split by id % g', re-replicated over dst rows ---
    rows, u_src = _tile_records(logical.u_row, gcd_n, dst.n_i // gcd_n)
    uid = logical.u_id[u_src]
    u_dest = ((rows.long() * dst.g + uid % dst.g) * u_cap
              + state_lib.user_slot(uid, dst, u_cap))
    user_ids, user_freq, user_ts, user_vecs, _ = _scatter_merge(
        ids=uid, ts=logical.u_ts[u_src], freq=logical.u_freq[u_src],
        dest=u_dest, n_slots=n_c * u_cap, vec=logical.u_vec[u_src],
        merge=merge)

    # --- item replicas: split by id % n_i', re-replicated over dst cols ---
    cols, i_src = _tile_records(logical.i_col, gcd_g, dst.g // gcd_g)
    iid = logical.i_id[i_src]
    i_dest = (((iid.long() % dst.n_i) * dst.g + cols) * i_cap
              + state_lib.item_slot(iid, dst, i_cap))
    item_ids, item_freq, item_ts, item_vecs, item_cnt = _scatter_merge(
        ids=iid, ts=logical.i_ts[i_src], freq=logical.i_freq[i_src],
        dest=i_dest, n_slots=n_c * i_cap, vec=logical.i_vec[i_src],
        cnt=logical.i_cnt[i_src], merge=merge)

    uid_tab = user_ids.reshape(n_c, u_cap)
    iid_tab = item_ids.reshape(n_c, i_cap)

    # --- rated pairs: exactly partitioned, each pair has ONE target; it
    # survives where both its ids won their target slots ---
    pu, pi = _rated_pairs(logical)
    ok = (pu >= 0) & (pi >= 0)
    pu, pi = pu[ok], pi[ok]
    pw = ((pi % dst.n_i) * dst.g + (pu % dst.g)).long()
    psu = state_lib.user_slot(pu, dst, u_cap).long()
    psi = state_lib.item_slot(pi, dst, i_cap).long()
    keep = (uid_tab[pw, psu] == pu) & (iid_tab[pw, psi] == pi)
    rated = torch.zeros((n_c, u_cap, i_cap), dtype=torch.bool, device=dev)
    rated[pw[keep], psu[keep], psi[keep]] = True

    # --- DICS co-occurrence blocks: re-partition by the new item splits,
    # merge across congruent source columns (JAX's loop) ---
    if is_disgd:
        co = torch.zeros((n_c, 0, 0), dtype=logical.co.dtype, device=dev)
    else:
        src_nc, s_icap = logical.co.shape[0], logical.co.shape[-1]
        n_co = n_c * i_cap * i_cap
        co_flat = torch.zeros((n_co + 1,), dtype=logical.co.dtype,
                              device=dev)
        src_col = (torch.arange(src_nc, dtype=torch.int64, device=dev)
                   % src.g)[:, None, None]
        ids = logical.i_id.reshape(src_nc, s_icap).long()
        p3, q3 = ids[:, :, None], ids[:, None, :]
        prow = p3 % dst.n_i
        sp = state_lib.item_slot(p3, dst, i_cap)
        sq = state_lib.item_slot(q3, dst, i_cap)
        pair_ok = (p3 >= 0) & (q3 >= 0) & (prow == q3 % dst.n_i)
        iid_l = iid_tab.long()
        for t in range(dst.g // gcd_g):
            c_new = src_col % gcd_g + t * gcd_g
            cw = prow * dst.g + c_new
            keep_co = (pair_ok & (iid_l[cw, sp] == p3)
                       & (iid_l[cw, sq] == q3))
            c_dest = torch.where(keep_co, (cw * i_cap + sp) * i_cap + sq,
                                 n_co)
            co_flat.index_add_(0, c_dest.reshape(-1),
                               logical.co.reshape(-1))
        co = co_flat[:n_co].reshape(n_c, i_cap, i_cap)

    # --- per-worker clocks: max over the merged source rectangle ---
    m = logical.clock.reshape(src.n_i // gcd_n, gcd_n, src.g // gcd_g,
                              gcd_g).amax(dim=(0, 2))
    r = (torch.arange(dst.n_i, device=dev) % gcd_n)[:, None]
    c = (torch.arange(dst.g, device=dev) % gcd_g)[None, :]
    clock = m[r, c].reshape(n_c)

    tables = Tables(
        user_ids=uid_tab, item_ids=iid_tab,
        user_freq=user_freq.reshape(n_c, u_cap),
        item_freq=item_freq.reshape(n_c, i_cap),
        user_ts=user_ts.reshape(n_c, u_cap),
        item_ts=item_ts.reshape(n_c, i_cap),
        clock=clock,
    )
    if is_disgd:
        out = DisgdState(tables=tables,
                         user_vecs=user_vecs.reshape(n_c, u_cap, -1),
                         item_vecs=item_vecs.reshape(n_c, i_cap, -1),
                         rated=rated)
    else:
        out = DicsState(tables=tables, co=co,
                        item_cnt=item_cnt.reshape(n_c, i_cap), rated=rated)
    if storage is not None:
        out = storage_lib.encode_state(out, storage)
    return out


def regrid(states, src: GridSpec, dst: GridSpec, *, u_cap: int | None = None,
           i_cap: int | None = None, merge: str = "fresh", storage=None,
           storage_out=None):
    """Reshape live worker states from grid ``src`` to grid ``dst``.

    ``regrid(states, grid, grid)`` is the identity, bit for bit. Target
    capacities default to the source's. ``storage`` names the policy the
    input states are encoded under; ``storage_out`` the target encoding
    (default: ``storage``; a different one migrates policies).
    """
    t = states.tables
    if u_cap is None:
        u_cap = t.user_ids.shape[1]
    if i_cap is None:
        i_cap = t.item_ids.shape[1]
    logical = extract_logical(states, src, storage=storage)
    return build_states(logical, src=src, dst=dst, u_cap=u_cap, i_cap=i_cap,
                        merge=merge,
                        storage=storage_out if storage_out is not None
                        else storage)
