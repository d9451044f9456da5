"""Meshes for the S&R worker grid, over ``torch.distributed``.

Port of ``repro/launch/mesh.py``: ``make_production_mesh`` (:20),
``make_cpu_mesh`` (:26) and ``make_grid_mesh`` (:31). A JAX mesh lays
devices out on named axes inside one program; here every worker of the
grid is a process of a ``torch.distributed`` group, one rank each, and a
:class:`Mesh` names the layout: its axis names, its shape, and, when it
is bound to the running group, that group and this process's rank.
Importing the module starts no process and touches neither the process
group nor CUDA.

A bound mesh carries two groups of the same ranks and backend: the
default group, which carries the trainer's collectives (the steps'
all-reduces, the boundaries' gathers, checkpoints and rescales), and a
serve group, which carries the reader's (``serve``'s agreement and the
plane's all-gathers), so that a ``recommend`` on another thread during
``ingest`` never interleaves its collectives with the trainer's on one
group. ``make_grid_mesh`` creates the serve group once per process, the
first time every rank calls it.

``run_on_ranks`` starts such a group on one host (the tests' and the
smoke's launcher): ``n_ranks`` processes by ``torch.multiprocessing``'s
spawn, a ``file://`` rendezvous in a fresh temporary directory (so two
groups never race for a port), the collective backend chosen once, up
front:

  * ``nccl`` when every rank has a card of its own;
  * ``gloo`` on the CPU, or when several ranks share a card (NCCL
    refuses two ranks on one GPU; gloo stages CUDA tensors through the
    host).

Rank ``r`` binds ``cuda:{r % device_count}`` unless the CPU is asked
for, and takes its share of the host's cores for its CPU threads. A
rank that raises fails the call and the others are stopped; so is a
group that outlives its timeout. ``session_on_rank`` is a ready entry
for it: a ``StreamSession`` on the process grid.
"""

from __future__ import annotations

import datetime
import math
import os
import pickle
import tempfile
import time
from typing import Any, Callable, NamedTuple

__all__ = ["Mesh", "make_production_mesh", "make_cpu_mesh",
           "make_grid_mesh", "RankInfo", "RankRun", "run_on_ranks",
           "RankSession", "session_on_rank"]


class Mesh(NamedTuple):
    """A grid of ranks on named axes (``shape`` maps axis name to size,
    in ``axis_names`` order). ``group`` and ``rank`` are the process
    group and this process's rank when the mesh is bound to one, else
    ``None`` (a layout only, or a world of one process); ``world`` is the
    group's size, which may exceed the mesh's (the ranks from ``size`` up
    hold no coordinate). ``serve_group`` is the group of the same ranks
    that the serving plane's collectives run on (``None`` with
    ``group``)."""

    axis_names: tuple
    shape: dict
    group: Any = None
    rank: int | None = None
    world: int = 1
    serve_group: Any = None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def holds_worker(self) -> bool:
        """Whether this rank holds a coordinate of the mesh (a worker)."""
        return (self.rank or 0) < self.size


def _layout(sizes, axes, group=None, rank=None, world=1,
            serve_group=None) -> Mesh:
    return Mesh(tuple(axes), dict(zip(axes, sizes)), group, rank, world,
                serve_group)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production layouts: ``(data=16, model=16)``, and with
    ``multi_pod`` ``(pod=2, data=16, model=16)``, whose ``pod`` axis
    widens the paper's user-group axis. A layout: it binds no group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _layout(shape, axes)


def make_cpu_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A small ``(data, model)`` layout, as the tests use."""
    return _layout((data, model), ("data", "model"))


# The serve group of the running default group: (default group, serve
# group), made by the first ``make_grid_mesh`` of the process group.
_serve = (None, None)
# The timeout ``run_on_ranks`` gave the default group, for the serve group.
_timeout = None


def _serve_group(world_group):
    """The serve group beside ``world_group``: the same ranks and
    backend, created once (every rank must create it in the same order,
    so it is made where every rank calls ``make_grid_mesh``)."""
    global _serve
    import torch.distributed as dist

    if _serve[0] is not world_group:
        kw = {} if _timeout is None else {"timeout": _timeout}
        _serve = (world_group, dist.new_group(
            backend=dist.get_backend(world_group), **kw))
    return _serve[1]


def _world():
    """(process group, rank, world size, serve group) of the running
    default group; ``(None, 0, 1, None)`` without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        world = dist.group.WORLD
        return (world, dist.get_rank(), dist.get_world_size(),
                _serve_group(world))
    return None, 0, 1, None


def make_grid_mesh(grid) -> Mesh:
    """A ``(data=g, model=n_i)`` mesh bound to the default process group,
    one rank per worker of the S&R ``GridSpec`` (``core/distributed.py``
    places worker ``w`` on rank ``w``). As ``jax.make_mesh``, it takes
    the first ``n_c`` ranks of a larger group: the ranks from ``n_c`` up
    hold no worker (``Mesh.holds_worker``) but run the same loop and
    issue the same collectives, adding nothing to them. Raises
    ``ValueError`` with JAX's message when the group has fewer than
    ``n_c`` ranks. Without a process group the world is this one
    process. The first call in a process group creates the mesh's serve
    group (``Mesh.serve_group``): every rank must make it."""
    group, rank, have, serve = _world()
    needed = grid.n_c
    if have < needed:
        raise ValueError(
            f"S&R grid needs {needed} devices ({grid.n_i}x{grid.g}); "
            f"only {have} available")
    return _layout((grid.g, grid.n_i), ("data", "model"), group, rank, have,
                   serve)


def _choose_backend(n_ranks: int, device: str) -> str:
    """The collective backend for ``n_ranks`` processes on ``device``:
    ``nccl`` when each rank has a card of its own, else ``gloo``."""
    if device == "cpu":
        return "gloo"
    import torch

    return "nccl" if torch.cuda.device_count() >= n_ranks else "gloo"


class RankInfo(NamedTuple):
    """What a rank's function is told: its rank, the world size, its
    device (``"cpu"`` or ``"cuda:<n>"``) and the group's backend."""

    rank: int
    world: int
    device: str
    backend: str


class RankRun(NamedTuple):
    """``run_on_ranks``'s report: the backend it chose, how many ranks
    share a card (0 on the CPU), and each rank's return value."""

    backend: str
    ranks_per_card: int
    results: list


def _rank_main(rank, world, device, backend, tmp, timeout):
    global _timeout
    import torch
    import torch.distributed as dist

    with open(os.path.join(tmp, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)

    # The host's cores are shared by the ranks.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if device == "cpu":
        dev = "cpu"
    else:
        # Asked for a card: no CPU fallback.
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: no CUDA device")
        index = rank % torch.cuda.device_count()
        torch.cuda.set_device(index)
        dev = f"cuda:{index}"
    _timeout = datetime.timedelta(seconds=timeout)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
        world_size=world, rank=rank, timeout=_timeout)
    try:
        out = fn(RankInfo(rank, world, dev, backend), *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_on_ranks(fn: Callable, n_ranks: int, device: str, *args,
                 timeout: float = 600.0) -> RankRun:
    """Run ``fn(RankInfo, *args)`` on ``n_ranks`` spawned processes that
    form one default process group; ``device`` is ``"cpu"`` or
    ``"cuda"``. ``fn`` must be importable by the children (a module-level
    function) and return something picklable. Returns a
    :class:`RankRun`. Raises ``TimeoutError`` (the ranks killed) when the
    group is not done within ``timeout`` seconds, and the rank's error
    when one fails (the others are terminated)."""
    import torch
    import torch.multiprocessing as mp

    backend = _choose_backend(n_ranks, device)
    per_card = (0 if device == "cpu"
                else math.ceil(n_ranks / max(torch.cuda.device_count(), 1)))
    with tempfile.TemporaryDirectory(prefix="sr-grid-") as tmp:
        # The call goes by file: a child that fails before it reads its
        # spawn arguments would leave the parent blocked on a full pipe.
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        ctx = mp.start_processes(
            _rank_main, args=(n_ranks, device, backend, tmp, timeout),
            nprocs=n_ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{n_ranks} ranks ({backend}) not done in "
                        f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for r in range(n_ranks):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return RankRun(backend, per_card, results)


class RankSession(NamedTuple):
    """One session of :func:`session_on_rank`, as a rank saw it: the
    ``ingest``'s ``StreamResult`` (``final_states`` as host arrays, the
    rank's worker), ``recommend``'s ``ServeResponse`` (the grid's answer,
    the same on every rank), the collectives the rank issued
    (``core.distributed.collective_stats()``) and its kernel launches
    (``kernels.ops.launch_counts()``)."""

    result: Any
    response: Any
    collectives: dict
    launches: dict


def session_on_rank(info: RankInfo, cases, publish_every: int = 2) -> list:
    """``run_on_ranks`` entry: each ``(users, items, cfg, queries)`` case
    through a ``StreamSession`` with ``backend="shard_map"`` on this
    rank's device: ``ingest`` under a sync ``PublishPolicy(every=
    publish_every)``, then ``recommend(queries)``. Returns a
    :class:`RankSession` per case."""
    import dataclasses

    from repro_torch.core import convert, distributed
    from repro_torch.kernels import ops
    from repro_torch.serve.policy import PublishPolicy
    from repro_torch.session import StreamSession

    out = []
    for users, items, cfg, queries in cases:
        cfg = dataclasses.replace(cfg, backend="shard_map",
                                  device=info.device)
        distributed.reset_collective_stats()
        ops.reset_launch_counts()
        s = StreamSession(cfg, publish=PublishPolicy(every=publish_every,
                                                     mode="sync"))
        res = s.ingest(users, items)
        resp = s.recommend(queries)
        res = dataclasses.replace(
            res, final_states=convert.states_to_numpy(res.final_states))
        out.append(RankSession(res, resp, distributed.collective_stats(),
                               ops.launch_counts()))
    return out
