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
  * ``rated`` and ``co`` are rebuilt from their live entries
    (``Relations``: ``nonzero``, worker by worker), not through JAX's
    dense ``[n_c, u_cap, i_cap]`` index temporaries (33.8 GB of int64 at
    that size). That reads the number of entries on the host: regrid
    runs between stream segments. A zero ``co`` entry adds nothing, so
    the sums are JAX's.

``Relations`` are also what a process grid exchanges for a rescale
(``core.distributed.exchange_logical``): their size is what the stream
made, not the tables'.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import state as state_lib
from repro_torch.core import storage as storage_lib
from repro_torch.core.routing import GridSpec
from repro_torch.core.state import DicsState, DisgdState, Tables

__all__ = ["LogicalState", "Relations", "CheckpointShapeError",
           "extract_logical", "relations_of", "build_states", "regrid"]


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


def extract_logical(states, grid: GridSpec, storage=None,
                    workers: range | None = None) -> LogicalState:
    """Flatten stacked ``[n_c, ...]`` worker states into a LogicalState.

    ``storage`` names the policy the states are resident under; the
    logical form is always the decoded compute form (a new tensor for
    every decoded table), so it is policy-portable.

    ``workers`` names the grid's workers the stack holds (default: all of
    them, ``range(grid.n_c)``); the records' provenance is their grid
    coordinates (``w // g``, ``w % g``). A rank of the process grid
    passes its own (``range(w, w + 1)``, or an empty range past the grid)
    and gets its share: its records, its ``rated`` and ``co`` blocks and
    its clock as ``[len(workers)]``, which ``core.distributed.
    gather_logical`` joins into the whole grid's.
    """
    if storage is not None:
        states = storage_lib.decode_state(states, storage)
    t = states.tables
    n_c, u_cap = t.user_ids.shape
    i_cap = t.item_ids.shape[1]
    whole = workers is None
    if whole:
        workers = range(grid.n_c)
    if n_c != len(workers):
        raise CheckpointShapeError(n_c, grid, "stacked states/grid mismatch")
    dev = t.user_ids.device
    w = torch.arange(workers.start, workers.stop, dtype=torch.int32,
                     device=dev)
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
        clock=t.clock.reshape(grid.n_i, grid.g) if whole else t.clock,
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


class Relations(NamedTuple):
    """A ``LogicalState``'s ``rated`` and ``co`` as lists of their live
    entries by global id, source worker-major, each worker's in row-major
    order: all that ``build_states`` reads of them."""

    pu: torch.Tensor        # i32, global user of each rated pair
    pi: torch.Tensor        # i32, global item of each rated pair
    c_col: torch.Tensor     # i32, source grid column of each co entry
    c_p: torch.Tensor       # i32, global item of its row
    c_q: torch.Tensor       # i32, global item of its column
    c_v: torch.Tensor       # f32, its count (non-zero)


def relations_of(logical: LogicalState, grid: GridSpec,
                 workers: range | None = None, block=None) -> Relations:
    """The live entries of ``logical``'s ``rated`` and ``co``, worker by
    worker (each ``nonzero`` under 2^31 elements). ``workers`` are the
    grid's workers the records hold (default all); ``block(j)`` gives
    the ``j``-th one's ``(rated, co)`` in compute form on the records'
    device (default: ``logical.rated[j]``, ``logical.co[j]``), so that a
    caller may hold the tables elsewhere and decode one worker at a
    time."""
    if workers is None:
        workers = range(grid.n_c)
    if block is None:
        def block(j):
            return logical.rated[j], logical.co[j]
    parts = []
    for j, w in enumerate(workers):
        u_tab = logical.u_id.reshape(len(workers), -1)
        i_tab = logical.i_id.reshape(len(workers), -1)
        rated, co = block(j)
        su, si = rated.nonzero(as_tuple=True)
        pu, pi = u_tab[j][su], i_tab[j][si]
        ok = (pu >= 0) & (pi >= 0)
        a, b = co.nonzero(as_tuple=True)
        cp, cq = i_tab[j][a], i_tab[j][b]
        live = (cp >= 0) & (cq >= 0)
        cp, cq = cp[live], cq[live]
        parts.append((pu[ok], pi[ok], torch.full_like(cp, w % grid.g), cp,
                      cq, co[a[live], b[live]]))
    if not parts:
        dev = logical.u_id.device
        i32 = torch.zeros(0, dtype=torch.int32, device=dev)
        return Relations(i32, i32, i32, i32, i32,
                         torch.zeros(0, dtype=torch.float32, device=dev))
    return Relations(*(torch.cat(x) for x in zip(*parts)))


def _local(dest, src_idx, ids, lo: int, n: int, cap: int):
    """The records whose destination slot lies in workers ``[lo, lo +
    n)``, their slots counted from worker ``lo``. Filtering keeps the
    records' order, so the tie-break on the lowest index is unchanged."""
    keep = (dest >= lo * cap) & (dest < (lo + n) * cap)
    return dest[keep] - lo * cap, src_idx[keep], ids[keep]


def build_states(logical: LogicalState, *, src: GridSpec, dst: GridSpec,
                 u_cap: int, i_cap: int, merge: str = "fresh", storage=None,
                 workers: range | None = None,
                 relations: Relations | None = None):
    """Rebuild stacked ``[dst.n_c, ...]`` worker states from a LogicalState.

    ``u_cap`` / ``i_cap`` are the target capacities (a shrink evicts as a
    slot insert would: the freshest tenant wins). The algorithm is carried
    by the leaves (zero-width ``co`` means DISGD). ``storage`` encodes the
    rebuilt states (the target policy when regrid migrates policies).

    ``workers`` (a ``range`` of the destination's workers, default all)
    builds those workers only, ``[len(workers), ...]``, equal bit for bit
    to the same rows of the whole build: a rank of the process grid
    builds its own worker and allocates no other's tables.

    ``relations`` (default ``relations_of(logical, src)``) stand in for
    ``logical.rated`` and ``logical.co``, which are then not read but
    for their trailing shape (``[0, ...]`` will do); the records may then
    be any worker-major subset that keeps every live one (a process
    grid's exchange sends the live records only).
    """
    is_disgd = logical.co.shape[-1] == 0
    if workers is None:
        workers = range(dst.n_c)
    lo, n_c = workers.start, len(workers)
    gcd_n = math.gcd(src.n_i, dst.n_i)
    gcd_g = math.gcd(src.g, dst.g)
    dev = logical.u_id.device
    if relations is None:
        relations = relations_of(logical, src)

    # --- user replicas: split by id % g', re-replicated over dst rows ---
    rows, u_src = _tile_records(logical.u_row, gcd_n, dst.n_i // gcd_n)
    uid = logical.u_id[u_src]
    u_dest = ((rows.long() * dst.g + uid % dst.g) * u_cap
              + state_lib.user_slot(uid, dst, u_cap))
    u_dest, u_src, uid = _local(u_dest, u_src, uid, lo, n_c, u_cap)
    user_ids, user_freq, user_ts, user_vecs, _ = _scatter_merge(
        ids=uid, ts=logical.u_ts[u_src], freq=logical.u_freq[u_src],
        dest=u_dest, n_slots=n_c * u_cap, vec=logical.u_vec[u_src],
        merge=merge)

    # --- item replicas: split by id % n_i', re-replicated over dst cols ---
    cols, i_src = _tile_records(logical.i_col, gcd_g, dst.g // gcd_g)
    iid = logical.i_id[i_src]
    i_dest = (((iid.long() % dst.n_i) * dst.g + cols) * i_cap
              + state_lib.item_slot(iid, dst, i_cap))
    i_dest, i_src, iid = _local(i_dest, i_src, iid, lo, n_c, i_cap)
    item_ids, item_freq, item_ts, item_vecs, item_cnt = _scatter_merge(
        ids=iid, ts=logical.i_ts[i_src], freq=logical.i_freq[i_src],
        dest=i_dest, n_slots=n_c * i_cap, vec=logical.i_vec[i_src],
        cnt=logical.i_cnt[i_src], merge=merge)

    uid_tab = user_ids.reshape(n_c, u_cap)
    iid_tab = item_ids.reshape(n_c, i_cap)

    # --- rated pairs: exactly partitioned, each pair has ONE target; it
    # survives where both its ids won their target slots ---
    pu, pi = relations.pu, relations.pi
    pw = ((pi % dst.n_i) * dst.g + (pu % dst.g)).long()
    mine = (pw >= lo) & (pw < lo + n_c)
    pu, pi, pw = pu[mine], pi[mine], pw[mine] - lo
    psu = state_lib.user_slot(pu, dst, u_cap).long()
    psi = state_lib.item_slot(pi, dst, i_cap).long()
    keep = (uid_tab[pw, psu] == pu) & (iid_tab[pw, psi] == pi)
    rated = torch.zeros((n_c, u_cap, i_cap), dtype=torch.bool, device=dev)
    rated[pw[keep], psu[keep], psi[keep]] = True

    # --- DICS co-occurrence blocks: re-partition by the new item splits,
    # merge across congruent source columns (JAX's loop) ---
    if is_disgd or not n_c:
        side = 0 if is_disgd else i_cap
        co = torch.zeros((n_c, side, side), dtype=logical.co.dtype,
                         device=dev)
    else:
        n_co = n_c * i_cap * i_cap
        co_flat = torch.zeros((n_co,), dtype=relations.c_v.dtype, device=dev)
        p, q = relations.c_p.long(), relations.c_q.long()
        prow = p % dst.n_i
        same_row = prow == q % dst.n_i
        sp = state_lib.item_slot(p, dst, i_cap).long()
        sq = state_lib.item_slot(q, dst, i_cap).long()
        col = relations.c_col.long() % gcd_g
        iid_l = iid_tab.long()
        for t in range(dst.g // gcd_g):
            cw = prow * dst.g + col + t * gcd_g
            sel = (same_row & (cw >= lo) & (cw < lo + n_c)).nonzero()[:, 0]
            cw_s, sp_s, sq_s = cw[sel] - lo, sp[sel], sq[sel]
            ok = (iid_l[cw_s, sp_s] == p[sel]) & (iid_l[cw_s, sq_s] == q[sel])
            co_flat.index_add_(0, ((cw_s * i_cap + sp_s) * i_cap + sq_s)[ok],
                               relations.c_v[sel][ok])
        co = co_flat.reshape(n_c, i_cap, i_cap)

    # --- per-worker clocks: max over the merged source rectangle ---
    m = logical.clock.reshape(src.n_i // gcd_n, gcd_n, src.g // gcd_g,
                              gcd_g).amax(dim=(0, 2))
    r = (torch.arange(dst.n_i, device=dev) % gcd_n)[:, None]
    c = (torch.arange(dst.g, device=dev) % gcd_g)[None, :]
    clock = m[r, c].reshape(-1)[lo:lo + n_c]

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
                         user_vecs=user_vecs.unflatten(0, (n_c, u_cap)),
                         item_vecs=item_vecs.unflatten(0, (n_c, i_cap)),
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
