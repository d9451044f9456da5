"""The S&R worker grid across processes (``backend="shard_map"``).

Port of ``repro/core/distributed.py``: ``grid_axes`` (:51),
``grid_from_mesh`` (:57), ``init_grid_states`` (:71),
``grid_state_specs`` (:82), ``make_grid_step`` (:123) and
``make_flat_grid_worker`` (:128). JAX places each worker on a coordinate
of a device mesh inside one program (``shard_map``); here each worker is
a rank of a ``torch.distributed`` process group
(``launch.mesh.make_grid_mesh``): worker ``w`` on rank ``w``,
worker-major as the engine lays its buckets out (``key = row * g +
col``).

Shared nothing: a rank allocates and updates only its own worker's
state, a ``[1, ...]`` stack. Every rank sees the whole stream and routes
it itself (the same inputs give the same buckets on every rank), then
runs the reference worker on its own bucket (``engine.make_worker_fn(cfg,
"scan", codecs=False)``, as JAX's ``shard_map`` runs ``make_worker_step``;
a worker draws from ``(key, clock, id)``, never its index, so a lone
worker draws what it draws in the batch). The only traffic is what every
rank must agree on after a step: the hit and evaluation bits of every
bucket slot, packed in one int32 buffer that is zero outside the rank's
row and summed by one ``all_reduce`` (a slot has one writer, so the sum
is the bits). The engine's step (``core/engine.py``) folds its
per-worker reductions (the telemetry list length, the occupancies) into
the same buffer through :func:`gather_bits`.

A group may hold more ranks than the grid has workers
(``make_grid_mesh``, as ``jax.make_mesh`` takes ``n_c`` of more
devices): the ranks from ``n_c`` up hold an empty ``[0, ...]`` state,
run the same loop on no events and put zero rows into every collective,
so that every rank issues the same collectives in the same order.

The live session on the grid (``session.StreamSession`` with
``backend="shard_map"``) exchanges four more things, each in one int32
buffer a rank: the serving plane's partial lists
(``serve.plane.grid_topn``) and the popularity head's item ids and
weights (``gather_item_stats``), each in one all-gather
(``grid_all_gather``); the logical state of a checkpoint, gathered on
rank 0 only, which writes the file (``gather_logical``, one gather);
and that of a rescale, which every rank needs to build its destination
worker (``exchange_logical``): the live records and the live entries of
``rated`` and ``co`` (``regrid.Relations``), never the dense tables, in
two all-gathers (the lengths, then the padded entries). So only rank 0,
at a checkpoint, ever holds the grid's dense tables.

Two groups of the same ranks carry them (``launch.mesh.Mesh``): the
default group (``group="train"``) every collective of the trainer's
thread (the steps, the boundaries' popularity gathers, checkpoints and
rescales), the serve group (``group="serve"``) the reader's: the
plane's all-gathers and the agreement of a ``serve`` call
(:func:`serve_agree`, one all-reduce of a few int64 words). A thread
never issues a collective on the other's group, so a ``recommend``
during ``ingest`` cannot pair one rank's all-gather with another's
all-reduce.

``collective_stats(group)`` counts a group's collectives since the
last ``reset_collective_stats()``, the bytes they wrote on this rank and
their milliseconds (CUDA events on a card, read when asked; the host
clock on the CPU, where gloo's collectives return when they are
done). Each group has its own counter: the trainer's thread and the
reader's never share one. On a mesh that is a layout only (no process
group, as the dry-run's production mesh) an all-reduce is not run:
``layout_collectives(group)`` lists it, as ``(kind, result bytes, group
size)``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple

import torch

from repro_torch.core import algorithm as algorithm_lib
from repro_torch.core import state as state_lib
from repro_torch.core.routing import GridSpec

__all__ = [
    "grid_axes",
    "grid_from_mesh",
    "make_grid_step",
    "make_flat_grid_worker",
    "init_grid_states",
    "grid_state_specs",
    "local_rows",
    "rank_workers",
    "rank_states",
    "grid_all_reduce",
    "grid_all_gather",
    "gather_bits",
    "gather_item_stats",
    "gather_logical",
    "exchange_logical",
    "serve_agree",
    "collective_stats",
    "reset_collective_stats",
    "layout_collectives",
    "RankStream",
    "stream_on_rank",
]

# The mesh's groups by name: the trainer's and the reader's.
GROUPS = ("train", "serve")


def _zero() -> dict:
    return {"calls": 0, "bytes": 0, "host_ms": 0.0, "events": [],
            "layout": []}


# A group's collectives since the last reset: their count, the bytes they
# wrote on this rank, host milliseconds (CPU) and (start, end) CUDA event
# pairs (card); and those a layout's mesh issued without running them.
_stats = {name: _zero() for name in GROUPS}


def collective_stats(group: str = "train") -> dict:
    """``{"calls": n, "bytes": b, "ms": t}``: ``group``'s collectives
    (``"train"``, the default group, or ``"serve"``), the bytes they
    wrote on this rank (an all-reduce's buffer, a gather's output) and
    their milliseconds since the last reset (waits for the card's pending
    events)."""
    st = _stats[group]
    ms = st["host_ms"]
    for a, b in list(st["events"]):
        b.synchronize()
        ms += a.elapsed_time(b)
    return {"calls": st["calls"], "bytes": st["bytes"], "ms": ms}


def layout_collectives(group: str = "train") -> list:
    """``(kind, result bytes, group size)`` of each collective that
    ``group`` issued on a layout's mesh since the last reset."""
    return list(_stats[group]["layout"])


def reset_collective_stats() -> None:
    """Zero every group's counter."""
    for name in GROUPS:
        _stats[name] = _zero()


def _group(mesh, group: str):
    """The process group ``group`` names on ``mesh`` (None in a world of
    one process)."""
    if group == "train":
        return mesh.group
    if group == "serve":
        return mesh.serve_group
    raise ValueError(f"unknown group {group!r}; one of {GROUPS}")


def grid_axes(mesh):
    """(item_axis, user_axes) mesh mapping for the S&R grid."""
    user_axes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    return "model", user_axes


def grid_from_mesh(mesh) -> GridSpec:
    """The S&R ``GridSpec`` a mesh realizes (item axis x user axes): the
    inverse of ``launch.mesh.make_grid_mesh``."""
    item_ax, user_axes = grid_axes(mesh)
    n_i = mesh.shape[item_ax]
    g = math.prod(mesh.shape[a] for a in user_axes)
    return GridSpec.rect(n_i, g)


def _check_grid(cfg, mesh) -> None:
    shape = grid_from_mesh(mesh).shape
    if cfg.grid.shape != shape:
        raise ValueError(f"config grid {cfg.grid.shape} does not match the "
                         f"mesh's {shape}")


def _worker(mesh) -> int:
    """The worker this process runs: its rank (0 in a world of one; ``n_c``
    or more on a rank that holds none)."""
    return mesh.rank or 0


def _n_local(mesh) -> int:
    """Workers this rank holds: 1, or 0 past the grid."""
    return int(mesh.holds_worker)


def rank_workers(mesh) -> range:
    """The grid's workers this rank holds: its own, or none past the
    grid (``regrid``'s ``workers=``)."""
    w = _worker(mesh)
    return range(w, w + _n_local(mesh))


def local_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's row ``[1, ...]`` of a worker-major ``[n_c, ...]``
    tensor (a view; ``[0, ...]`` on a rank without a worker)."""
    w = _worker(mesh)
    return x[w:w + 1]


def init_grid_states(cfg, mesh):
    """This rank's worker state, a ``[1, ...]`` stack on ``cfg.device`` in
    ``cfg.storage``'s encoding (``[0, ...]``, no memory, on a rank without
    a worker). JAX's is the whole ``(n_i, g, ...)`` tree, sharded; here no
    rank holds another rank's tables."""
    from repro_torch.core import pipeline

    _check_grid(cfg, mesh)
    return pipeline.init_worker_states(cfg, _n_local(mesh))


def rank_states(mesh, states):
    """This rank's worker of ``states``: either its own ``[1, ...]``
    worker (``[0, ...]`` past the grid), returned as it is, or the whole
    grid's ``[n_c, ...]`` tree (JAX's ``initial_states``, what
    ``restore_stream_checkpoint`` builds in one process), whose row is
    copied out. Raises ``ValueError`` on any other leading size."""
    lead = states.tables.user_ids.shape[0]
    if lead == mesh.size:
        return type(states)(
            type(states.tables)(*(local_rows(mesh, t).clone()
                                  for t in states.tables)),
            *(None if t is None else local_rows(mesh, t).clone()
              for t in states[1:]))
    if lead == _n_local(mesh):
        return states
    raise ValueError(
        f"states of {lead} workers are neither the grid's {mesh.size} nor "
        f"rank {_worker(mesh)}'s {_n_local(mesh)}")


def grid_state_specs(cfg, mesh):
    """The mesh axes each state leaf's worker dimensions lie on, in the
    state's shape: ``(item_axis, user_axis)`` per leaf (JAX's
    ``P(item_ax, user)``; several user axes as a tuple). No memory is
    allocated."""
    item_ax, user_axes = grid_axes(mesh)
    user = user_axes if len(user_axes) > 1 else user_axes[0]
    spec = (item_ax, user)
    one = algorithm_lib.get_algorithm(cfg.algorithm).state_template(
        cfg.resolved_hyper(), cfg.storage)
    return type(one)(type(one.tables)(*(spec for _ in one.tables)),
                     *(None if t is None else spec for t in one[1:]))


def _timed(buf: torch.Tensor, call, out_bytes: int | None = None,
           group: str = "train") -> None:
    """Run one collective ``call()`` on ``buf``'s device, counted in
    ``group``'s stats with the ``out_bytes`` it writes here (default:
    ``buf``'s)."""
    st = _stats[group]
    st["calls"] += 1
    st["bytes"] += (buf.numel() * buf.element_size()
                    if out_bytes is None else out_bytes)
    if buf.is_cuda:
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        call()
        b.record()
        st["events"].append((a, b))
    else:
        t0 = time.perf_counter()
        call()
        st["host_ms"] += (time.perf_counter() - t0) * 1e3


def _all_reduce(mesh, buf: torch.Tensor, group: str = "train",
                op=None) -> None:
    import torch.distributed as dist

    pg = _group(mesh, group)
    if pg is None:      # a world of one process, or a layout (the dry-run)
        if mesh.size > 1:
            _stats[group]["layout"].append(
                ("all-reduce", buf.numel() * buf.element_size(), mesh.size))
        return
    op = dist.ReduceOp.SUM if op is None else op
    _timed(buf, lambda: dist.all_reduce(buf, op=op, group=pg), group=group)


def serve_agree(mesh, values, device="cpu") -> list:
    """The agreement of a ``serve`` call: the largest of each of
    ``values`` (ints) over the ranks, by one all-reduce (MAX) of one
    int64 buffer on the serve group; every rank gets the same list. On
    the host under gloo, on ``device`` (the rank's card) under NCCL,
    which reduces card buffers only."""
    import torch.distributed as dist

    pg = mesh.serve_group
    if pg is None:      # a world of one process
        return [int(v) for v in values]
    dev = "cpu" if dist.get_backend(pg) == "gloo" else device
    buf = torch.tensor([int(v) for v in values], dtype=torch.int64,
                       device=dev)
    _all_reduce(mesh, buf, "serve", dist.ReduceOp.MAX)
    return buf.tolist()


def grid_all_reduce(mesh, rows, scalars=()):
    """One ``all_reduce`` that gives every rank the whole grid.

    ``rows`` are this rank's int ``[1, ...]`` tensors (its worker's row of
    a worker-major ``[n_c, ...]`` value; at least one), ``scalars`` 0-d
    int tensors or ints that are summed over the ranks. Returns ``(rows,
    scalars)``: the int32 ``[n_c, ...]`` tensors, every rank's row in
    place, and the 0-d int32 sums. One int32 buffer, zero outside this
    rank's rows."""
    n_c = mesh.size
    w = _worker(mesh)
    device = rows[0].device
    sizes = [math.prod(r.shape[1:]) for r in rows]
    buf = torch.zeros(n_c * sum(sizes) + len(scalars), dtype=torch.int32,
                      device=device)
    off = 0
    for r, m in zip(rows, sizes):
        if r.shape[0]:          # a rank past the grid adds zeros
            buf[off + w * m:off + (w + 1) * m] = r.reshape(-1)
        off += n_c * m
    if scalars:
        buf[off:] = torch.stack([
            s.to(torch.int32) if torch.is_tensor(s)
            else torch.full((), s, dtype=torch.int32, device=device)
            for s in scalars])
    _all_reduce(mesh, buf)
    out, off = [], 0
    for r, m in zip(rows, sizes):
        out.append(buf[off:off + n_c * m].view((n_c,) + tuple(r.shape[1:])))
        off += n_c * m
    return out, list(buf[off:])


def _as_i32(t: torch.Tensor) -> torch.Tensor:
    """``t``'s 4-byte words (float32 and uint32 by their bits) or its
    values (bool, int32), as int32."""
    if t.dtype == torch.uint32:
        return state_lib.signed(t.contiguous())
    if t.dtype == torch.float32:
        return t.contiguous().view(torch.int32)
    if t.dtype in (torch.int32, torch.bool):
        return t.to(torch.int32)
    raise TypeError(f"no int32 form for {t.dtype}")


def _from_i32(x: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.float32:
        return x.view(torch.float32)
    if dtype == torch.uint32:
        return x.view(torch.uint32)
    return x != 0 if dtype == torch.bool else x


def _own_rows(mesh, rows) -> torch.Tensor:
    """This rank's ``[1, ...]`` rows as one flat int32 buffer (zeros of
    the same length on a rank without a worker)."""
    sizes = sum(math.prod(r.shape[1:]) for r in rows)
    if not _n_local(mesh):
        return torch.zeros(sizes, dtype=torch.int32, device=rows[0].device)
    return torch.cat([_as_i32(r).reshape(-1) for r in rows])


def _split_rows(mesh, out, rows):
    """``out``'s ``[n_c, total]`` words back into ``rows``' dtypes and
    ``[n_c, ...]`` shapes."""
    got, off = [], 0
    for r in rows:
        m = math.prod(r.shape[1:])
        x = out[:mesh.size, off:off + m].contiguous()
        got.append(_from_i32(x, r.dtype).view((mesh.size,)
                                              + tuple(r.shape[1:])))
        off += m
    return got


def grid_all_gather(mesh, rows, group: str = "train"):
    """One all-gather on ``group`` that gives every rank the whole grid's
    rows.

    ``rows`` are this rank's ``[1, ...]`` tensors (``[0, ...]`` on a rank
    without a worker, which adds zeros) of float32, uint32, int32 or
    bool. Returns the ``[n_c, ...]`` tensors, worker ``w``'s row from rank
    ``w``, in the rows' dtypes, bit for bit. One int32 buffer a rank."""
    import torch.distributed as dist

    pg = _group(mesh, group)
    if pg is None:      # a world of one process
        return list(rows)
    buf = _own_rows(mesh, rows)
    out = torch.empty((mesh.world, buf.numel()), dtype=torch.int32,
                      device=buf.device)
    _timed(buf, lambda: dist.all_gather(list(out.unbind(0)), buf, group=pg),
           out.numel() * 4, group)
    return _split_rows(mesh, out, rows)


def gather_item_stats(mesh, states, group: str = "train"):
    """The whole grid's ``state.item_stats``: item ids and popularity
    weights ``[n_c, i_cap]`` from this rank's worker, one all-gather on
    ``group``. Gathered before any aggregation, so that an item
    replicated on ``g`` workers counts every replica once."""
    ids, weight = state_lib.item_stats(states)
    return tuple(grid_all_gather(mesh, [ids, weight], group))


def grid_gather(mesh, rows):
    """``grid_all_gather`` to rank 0 only: the ``[n_c, ...]`` tensors
    there, ``None`` on every other rank, which receives nothing. One
    gather of one int32 buffer a rank, on the default group."""
    import torch.distributed as dist

    pg = mesh.group
    if pg is None:      # a world of one process
        return list(rows)
    buf = _own_rows(mesh, rows)
    root = not mesh.rank
    out = (torch.empty((mesh.world, buf.numel()), dtype=torch.int32,
                       device=buf.device) if root else None)
    _timed(buf, lambda: dist.gather(
        buf, list(out.unbind(0)) if root else None, dst=0, group=pg),
        out.numel() * 4 if root else 0)
    return _split_rows(mesh, out, rows) if root else None


def _all_gather_var(mesh, parts):
    """Every rank's int32 ``parts`` (1-D, their lengths free), on every
    rank: ``[rank][part]``. Two all-gathers on the default group: the
    lengths, then each rank's parts in one buffer padded to the
    longest."""
    import torch.distributed as dist

    pg = mesh.group
    if pg is None:      # a world of one process
        return [list(parts)]
    dev = parts[0].device
    lens = torch.tensor([p.numel() for p in parts], dtype=torch.int32,
                        device=dev)
    all_lens = torch.empty((mesh.world, lens.numel()), dtype=torch.int32,
                           device=dev)
    _timed(lens, lambda: dist.all_gather(list(all_lens.unbind(0)), lens,
                                         group=pg),
           all_lens.numel() * 4)
    all_lens = all_lens.tolist()
    width = max(1, max(sum(x) for x in all_lens))
    buf = torch.zeros(width, dtype=torch.int32, device=dev)
    buf[:sum(p.numel() for p in parts)] = torch.cat(list(parts))
    out = torch.empty((mesh.world, width), dtype=torch.int32, device=dev)
    _timed(buf, lambda: dist.all_gather(list(out.unbind(0)), buf, group=pg),
           out.numel() * 4)
    return [list(out[r].split(all_lens[r] + [width - sum(all_lens[r])])
                 [:-1]) for r in range(mesh.world)]


def _own_logical(mesh, states, grid, algorithm, storage):
    return algorithm_lib.get_algorithm(algorithm).extract_logical(
        states, grid, storage=storage, workers=rank_workers(mesh))


def gather_logical(mesh, states, grid, algorithm: str, storage=None):
    """The whole grid's ``regrid.LogicalState`` on rank 0, for the
    checkpoint it writes, from each rank's worker ``states`` (resident
    under ``storage``); ``None`` on every other rank. Each rank extracts
    its share (``extract_logical(workers=rank_workers(mesh))``) and one
    gather joins them on rank 0 (``grid_gather``), ``rated`` packed
    (``storage.pack_bits``). Returns ``(logical, rated_bits)``:
    ``logical.rated`` is the packed words, the rest equals
    ``extract_logical`` of the whole grid's stacked states, bit for
    bit."""
    from repro_torch.core import storage as storage_lib

    logical = _own_logical(mesh, states, grid, algorithm, storage)
    n = _n_local(mesh)
    per = {"u": states.tables.user_ids.shape[1],
           "i": states.tables.item_ids.shape[1]}
    rows = []
    for name, leaf in zip(logical._fields, logical):
        if name == "rated":
            rows.append(storage_lib.pack_bits(leaf))
        elif name in ("co", "clock"):
            rows.append(leaf)
        else:       # the flat records, [n * cap, ...] -> [n, cap, ...]
            rows.append(leaf.unflatten(0, (n, per[name[0]])))
    got = grid_gather(mesh, rows)
    if got is None:
        return None
    out = {}
    for name, leaf in zip(logical._fields, got):
        if name == "clock":
            out[name] = leaf.reshape(grid.n_i, grid.g)
        elif name in ("rated", "co"):
            out[name] = leaf
        else:
            out[name] = leaf.flatten(0, 1)
    return type(logical)(**out), logical.rated.shape[-1]


def exchange_logical(mesh, states, grid, algorithm: str, storage=None):
    """What every rank needs to build its worker of a rescaled grid
    (``regrid.build_states(relations=)``), from each rank's worker
    ``states`` (resident under ``storage``). Returns ``(logical,
    relations)``: the whole grid's live records (worker-major, in their
    order) and clocks in ``logical``, whose ``rated`` and ``co`` are
    ``[0, ...]``, and the whole grid's ``regrid.Relations``. Each rank
    sends its own live records and entries (``regrid.relations_of``), so
    what travels and what a rank holds is sized by what the stream
    made, not by the tables: no dense ``rated`` or ``co`` leaves a
    rank."""
    from repro_torch.core import regrid

    logical = _own_logical(mesh, states, grid, algorithm, storage)
    rel = regrid.relations_of(logical, grid, workers=rank_workers(mesh))
    u_live = logical.u_id >= 0
    i_live = logical.i_id >= 0
    parts = {}
    for name, leaf in zip(logical._fields, logical):
        if name not in ("rated", "co"):
            live = (u_live if name[0] == "u" else i_live
                    if name[0] == "i" else slice(None))
            parts[name] = leaf[live]
    parts.update(rel._asdict())
    got = _all_gather_var(mesh, [_as_i32(p).reshape(-1)
                                 for p in parts.values()])
    names = list(parts)
    joined = {}
    for j, (name, own) in enumerate(parts.items()):
        # A record's rows are its table's live ids (k may be 0).
        lead = names.index(name[0] + "_id") if name[:2] in ("u_", "i_") else j
        joined[name] = torch.cat([
            _from_i32(got[r][j], own.dtype).view(
                (got[r][lead].numel(),) + tuple(own.shape[1:]))
            for r in range(mesh.size)])
    joined["clock"] = joined["clock"].reshape(grid.n_i, grid.g)
    empty = {name: getattr(logical, name)[:0] for name in ("rated", "co")}
    out = type(logical)(**{name: joined.get(name, empty.get(name))
                           for name in logical._fields})
    return out, type(rel)(*(joined[name] for name in rel._fields))


def gather_bits(mesh, hits, evaluated, rows=(), sums=()):
    """The whole grid's bool ``[n_c, cap]`` ``hits`` and ``evaluated``
    from this rank's ``[1, cap]`` rows, with ``rows`` / ``sums`` of
    :func:`grid_all_reduce` folded into the same all-reduce (one int32
    code a slot: evaluated + 2 * hit). Returns ``(hits, evaluated,
    rows, sums)``."""
    code = evaluated.to(torch.int32) + 2 * hits.to(torch.int32)
    (code, *rows), sums = grid_all_reduce(mesh, [code, *rows], sums)
    return (code & 2) != 0, (code & 1) != 0, rows, sums


def make_flat_grid_worker(cfg, mesh):
    """``worker(states, ev_u, ev_i) -> (states, hits, evaluated)`` on the
    engine's worker-major layout: ``ev_u`` / ``ev_i`` are the whole
    grid's int32 ``[n_c, cap]`` buckets, ``states`` this rank's ``[1,
    ...]`` worker in compute form (updated in place), ``hits`` /
    ``evaluated`` the whole grid's bool ``[n_c, cap]``, the same on
    every rank (one ``all_reduce``)."""
    from repro_torch.core import engine

    _check_grid(cfg, mesh)
    one = engine.make_worker_fn(cfg, "scan", codecs=False)

    def worker(states, ev_u, ev_i):
        states, hits, evaluated = one(states, local_rows(mesh, ev_u),
                                      local_rows(mesh, ev_i))
        hits, evaluated, _, _ = gather_bits(mesh, hits, evaluated)
        return states, hits, evaluated

    return worker


def make_grid_step(cfg, mesh):
    """The grid step on the mesh layout: ``step(states, ev_u, ev_i)`` with
    the whole grid's int32 ``[n_i, g, cap]`` events returns ``(states,
    hits, evaluated)``, ``hits`` / ``evaluated`` the whole grid's bool
    ``[n_i, g, cap]`` (JAX's ``out_specs``), ``states`` this rank's
    worker. Row ``r``, column ``c`` is worker ``r * g + c``."""
    flat = make_flat_grid_worker(cfg, mesh)
    n_i, g = grid_from_mesh(mesh).shape

    def step(states, ev_u, ev_i):
        cap = ev_u.shape[-1]
        states, hits, evaluated = flat(states, ev_u.reshape(n_i * g, cap),
                                       ev_i.reshape(n_i * g, cap))
        return (states, hits.reshape(n_i, g, cap),
                evaluated.reshape(n_i, g, cap))

    return step


class RankStream(NamedTuple):
    """One stream of :func:`stream_on_rank`, as a rank saw it: the
    ``StreamResult`` with ``final_states`` as host arrays
    (``convert.states_to_numpy``), the collectives it issued
    (``collective_stats()``) and the peak bytes of the rank's card
    (``None`` on the CPU)."""

    result: object
    collectives: dict
    peak_bytes: int | None


def stream_on_rank(info, cases) -> list:
    """``launch.mesh.run_on_ranks`` entry: each ``(users, items, cfg)``
    case through ``run_stream`` with ``backend="shard_map"`` on this
    rank's device. Returns a :class:`RankStream` per case."""
    from repro_torch.core import convert, pipeline

    out = []
    for users, items, cfg in cases:
        cfg = dataclasses.replace(cfg, backend="shard_map",
                                  device=info.device)
        cuda = torch.device(info.device).type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(info.device)
        reset_collective_stats()
        res = pipeline.run_stream(users, items, cfg)
        stats = collective_stats()
        peak = torch.cuda.max_memory_allocated(info.device) if cuda else None
        res = dataclasses.replace(
            res, final_states=convert.states_to_numpy(res.final_states))
        out.append(RankStream(res, stats, peak))
    return out
