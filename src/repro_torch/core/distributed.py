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

``collective_stats()`` counts the collectives since the last
``reset_collective_stats()`` and their milliseconds (CUDA events on a
card, read when asked; the host clock on the CPU, where gloo's
``all_reduce`` returns when it is done).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple

import torch

from repro_torch.core import algorithm as algorithm_lib
from repro_torch.core.routing import GridSpec

__all__ = [
    "grid_axes",
    "grid_from_mesh",
    "make_grid_step",
    "make_flat_grid_worker",
    "init_grid_states",
    "grid_state_specs",
    "local_rows",
    "grid_all_reduce",
    "gather_bits",
    "collective_stats",
    "reset_collective_stats",
    "RankStream",
    "stream_on_rank",
]

# Collectives since the last reset: their count, host milliseconds (CPU)
# and (start, end) CUDA event pairs (card).
_stats = {"calls": 0, "host_ms": 0.0, "events": []}


def collective_stats() -> dict:
    """``{"calls": n, "ms": t}``: collectives and their milliseconds since
    the last reset (waits for the card's pending events)."""
    ms = _stats["host_ms"]
    for a, b in _stats["events"]:
        b.synchronize()
        ms += a.elapsed_time(b)
    return {"calls": _stats["calls"], "ms": ms}


def reset_collective_stats() -> None:
    _stats.update(calls=0, host_ms=0.0, events=[])


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
    """The worker this process runs: its rank (0 in a world of one)."""
    return mesh.rank or 0


def local_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's row ``[1, ...]`` of a worker-major ``[n_c, ...]``
    tensor (a view)."""
    w = _worker(mesh)
    return x[w:w + 1]


def init_grid_states(cfg, mesh):
    """This rank's worker state, a ``[1, ...]`` stack on ``cfg.device`` in
    ``cfg.storage``'s encoding. JAX's is the whole ``(n_i, g, ...)`` tree,
    sharded; here no rank holds another rank's tables."""
    from repro_torch.core import pipeline

    _check_grid(cfg, mesh)
    return pipeline.init_worker_states(cfg, 1)


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


def _all_reduce(mesh, buf: torch.Tensor) -> None:
    import torch.distributed as dist

    if mesh.group is None:      # a world of one process
        return
    _stats["calls"] += 1
    if buf.is_cuda:
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        dist.all_reduce(buf, group=mesh.group)
        b.record()
        _stats["events"].append((a, b))
    else:
        t0 = time.perf_counter()
        dist.all_reduce(buf, group=mesh.group)
        _stats["host_ms"] += (time.perf_counter() - t0) * 1e3


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
    sizes = [r[0].numel() for r in rows]
    buf = torch.zeros(n_c * sum(sizes) + len(scalars), dtype=torch.int32,
                      device=device)
    off = 0
    for r, m in zip(rows, sizes):
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
