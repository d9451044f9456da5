"""The active mesh and the collectives of the sharded program.

Port of ``repro/sharding/ctx.py``: ``active_mesh``, ``set_active_mesh``
and ``use_mesh`` (with sharding overrides). JAX's ``shard_act``
constrains an activation's layout and leaves GSPMD to insert the
collectives; the port's sharded program (``sharding.fsdp``) places its
arrays itself: parameters and AdamW's moments rest in blocks, each is
gathered where it is used and its gradient reduce-scattered back, the
batch is split over the batch axes and activations are whole on every
rank. So ``shard_act``'s call sites (``transformer.py:126,133,159,167``,
``attention.py:117-119``, ``moe.py:103,108``) have no runtime
counterpart here and the port has none.

The collectives run on the sub-groups of a mesh's axes: a group of the
ranks that differ only in the named axes, made by :func:`bind_mesh` on
the running default process group (every rank makes every group, in one
order). Each collective records ``(kind, result bytes, group size)``
(:func:`records`): ``"all-gather"``, ``"reduce-scatter"``,
``"all-reduce"``. On a mesh that is a layout only (no process group, as
the dry-run's production meshes and ``make_production_mesh``) a
collective records the same entry and returns an uninitialised tensor of
its result's shape: the dry-run traces the program a rank of the real
mesh runs, through the same code, with no process group. A collective
over axes of size 1 is no collective and records nothing.
"""

from __future__ import annotations

import contextlib
import itertools
import math
from typing import NamedTuple

import torch

from repro_torch.sharding import specs as specs_lib

__all__ = ["active_mesh", "set_active_mesh", "use_mesh", "active_overrides",
           "bind_mesh", "rank_coords", "BatchShard", "Record", "records",
           "reset_records", "all_gather", "reduce_scatter", "all_reduce",
           "gather", "gather_full", "gather_rows"]

_ACTIVE: list = [None]
_OVERRIDES: list = [None]


def active_mesh():
    return _ACTIVE[0]


def active_overrides():
    return _OVERRIDES[0]


def set_active_mesh(mesh, overrides: dict | None = None):
    _ACTIVE[0] = mesh
    _OVERRIDES[0] = overrides


@contextlib.contextmanager
def use_mesh(mesh, overrides: dict | None = None):
    prev, prev_ov = _ACTIVE[0], _OVERRIDES[0]
    _ACTIVE[0], _OVERRIDES[0] = mesh, overrides
    try:
        yield mesh
    finally:
        _ACTIVE[0], _OVERRIDES[0] = prev, prev_ov


# -- process groups ---------------------------------------------------------

# (axis names, sizes, axes) -> this rank's group over ``axes``.
_GROUPS: dict = {}


def _key(mesh, axes) -> tuple:
    return (tuple(mesh.axis_names), tuple(mesh.shape[a]
                                          for a in mesh.axis_names),
            tuple(sorted(axes, key=mesh.axis_names.index)))


def _members(mesh, rank: int, axes) -> list:
    """The ranks that differ from ``rank`` only in ``axes``, ascending."""
    c = specs_lib.coords_of(mesh, rank)
    return [r for r in range(mesh.size)
            if all(specs_lib.coords_of(mesh, r)[a] == c[a]
                   for a in mesh.axis_names if a not in axes)]


def bind_mesh(layout):
    """``layout`` (a ``launch.mesh.Mesh``) bound to the running default
    process group, whose size must be the layout's: rank ``r`` at
    coordinate ``r`` (row-major). Makes one group for every set of the
    layout's axes (every rank must call it, in the same order). Without a
    process group, the layout itself."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh

    if not (dist.is_available() and dist.is_initialized()):
        return layout
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != layout.size:
        raise ValueError(f"mesh of {layout.size} ranks ({layout.shape}) on "
                         f"a group of {world}")
    names = layout.axis_names
    for n in range(1, len(names) + 1):
        for axes in itertools.combinations(names, n):
            key = _key(layout, axes)
            parts, seen = [], set()
            for r in range(world):
                if r not in seen:
                    m = _members(layout, r, axes)
                    seen.update(m)
                    parts.append(m)
            mine, _ = dist.new_subgroups_by_enumeration(parts)
            _GROUPS[key] = (dist.group.WORLD, mine)
    return Mesh(tuple(names), dict(layout.shape), dist.group.WORLD, rank,
                world)


def rank_coords(mesh) -> dict:
    """This process's coordinate on each axis (rank 0's on a layout)."""
    return specs_lib.coords_of(mesh, mesh.rank or 0)


def _group(mesh, axes):
    """This rank's process group over ``axes`` (None on a layout)."""
    if mesh.group is None:
        return None
    world, pg = _GROUPS[_key(mesh, axes)]
    if world is not mesh.group:
        raise RuntimeError("the mesh's groups belong to an older process "
                           "group: bind_mesh again")
    return pg


# -- records ----------------------------------------------------------------


class Record(NamedTuple):
    """One collective: its kind, the bytes of its result on this rank and
    the size of its group."""

    kind: str
    nbytes: int
    group_size: int


_RECORDS: list = []


def records() -> list:
    """The collectives since the last :func:`reset_records`."""
    return list(_RECORDS)


def reset_records() -> None:
    _RECORDS.clear()


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _order(mesh, axes):
    """The group's members in block order: block ``i`` of a dim split
    over ``axes`` (major first) is held by ``out[i]``'s rank, as a
    position in the group's ascending member list."""
    rank = mesh.rank or 0
    members = _members(mesh, rank, axes)
    block = [specs_lib.block_index(axes, mesh,
                                   specs_lib.coords_of(mesh, m))[1]
             for m in members]
    return [block.index(i) for i in range(len(members))]


# -- collectives ------------------------------------------------------------


def all_gather(x: torch.Tensor, axes, dim: int, mesh=None) -> torch.Tensor:
    """The blocks of ``x`` over the ranks of ``axes``, concatenated along
    ``dim`` in block order (``axes`` major first)."""
    mesh = mesh or _ACTIVE[0]
    axes = specs_lib.entry_axes(axes)
    n = math.prod(mesh.shape[a] for a in axes)
    if n == 1:
        return x
    shape = list(x.shape)
    shape[dim] *= n
    _RECORDS.append(Record("all-gather", _nbytes(shape, x.dtype), n))
    pg = _group(mesh, axes)
    if pg is None:
        return x.new_empty(shape)
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=pg)
    return torch.cat([parts[j] for j in _order(mesh, axes)], dim=dim)


def reduce_scatter(x: torch.Tensor, axes, dim: int,
                   mesh=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, this rank's block of
    ``dim`` (the inverse of :func:`all_gather`)."""
    mesh = mesh or _ACTIVE[0]
    axes = specs_lib.entry_axes(axes)
    n = math.prod(mesh.shape[a] for a in axes)
    if n == 1:
        return x
    shape = list(x.shape)
    if shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {shape[dim]} over {n} ranks")
    shape[dim] //= n
    _RECORDS.append(Record("reduce-scatter", _nbytes(shape, x.dtype), n))
    pg = _group(mesh, axes)
    if pg is None:
        return x.new_empty(shape)
    import torch.distributed as dist

    blocks = x.chunk(n, dim=dim)
    # gloo reduce-scatters host tensors: a card's go through the host.
    host = x.is_cuda and dist.get_backend(pg) == "gloo"
    out = torch.empty(shape, dtype=x.dtype,
                      device="cpu" if host else x.device)
    dist.reduce_scatter(out, [(blocks[i].cpu() if host else blocks[i])
                              .contiguous()
                              for i in _inverse(_order(mesh, axes))],
                        group=pg)
    return out.to(x.device) if host else out


def _inverse(order: list) -> list:
    """Block index of each group position (the inverse permutation)."""
    out = [0] * len(order)
    for i, j in enumerate(order):
        out[j] = i
    return out


def all_reduce(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (a new tensor)."""
    mesh = mesh or _ACTIVE[0]
    axes = tuple(axes)
    n = math.prod(mesh.shape[a] for a in axes)
    if n == 1:
        return x
    _RECORDS.append(Record("all-reduce", _nbytes(x.shape, x.dtype), n))
    pg = _group(mesh, axes)
    if pg is None:
        return torch.empty_like(x)
    import torch.distributed as dist

    out = x.clone()
    dist.all_reduce(out, group=pg)
    return out


def gather_full(x: torch.Tensor, spec, mesh=None) -> torch.Tensor:
    """A whole array from this rank's block under ``spec`` (one all-gather
    a sharded dim, first dim first), without autograd."""
    mesh = mesh or _ACTIVE[0]
    for dim, entry in enumerate(spec):
        if entry is not None:
            x = all_gather(x, entry, dim, mesh)
    return x


class _Gather(torch.autograd.Function):
    """Gather a parameter's block into the whole array; the backward
    reduce-scatters the gradient back to the block: summed over the ranks
    that split the batch, taken as it is over the ranks that hold the
    same batch rows (they computed the same gradient)."""

    @staticmethod
    def forward(ctx, x, spec, mesh, batch):
        ctx.spec, ctx.mesh, ctx.batch = spec, mesh, batch
        return gather_full(x, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        spec, mesh, batch = ctx.spec, ctx.mesh, set(ctx.batch)
        for dim in reversed(range(len(spec))):
            axes = specs_lib.entry_axes(spec[dim])
            if not axes:
                continue
            summed = tuple(a for a in axes if a in batch)
            if summed == axes:
                g = reduce_scatter(g, axes, dim, mesh)
                continue
            if summed:
                g = all_reduce(g, summed, mesh)
            n, i = specs_lib.block_index(axes, mesh, rank_coords(mesh))
            g = g.narrow(dim, i * (g.shape[dim] // n), g.shape[dim] // n)
        rest = tuple(a for a in mesh.axis_names
                     if a in batch and a not in specs_lib.spec_axes(spec))
        if rest:
            g = all_reduce(g, rest, mesh)
        return g.contiguous(), None, None, None


def gather(x: torch.Tensor, spec, mesh=None, batch=()) -> torch.Tensor:
    """:func:`gather_full` under autograd: the gradient of the whole
    array comes back to ``x``'s block, summed over the step's batch axes
    ``batch``."""
    mesh = mesh or _ACTIVE[0]
    if not specs_lib.spec_axes(spec) and not batch:
        return x
    return _Gather.apply(x, tuple(spec), mesh, tuple(batch))


class _GatherRows(torch.autograd.Function):
    """Every rank's rows of an activation, in block order; the backward
    sums each row's gradient over the ranks and keeps this rank's."""

    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return all_gather(x, axes, 0, mesh)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.axes, 0, ctx.mesh), None, \
            None


def gather_rows(x: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """The whole batch of an activation whose rows (dim 0) are split over
    ``axes``, under autograd."""
    mesh = mesh or _ACTIVE[0]
    if math.prod(mesh.shape[a] for a in axes) == 1:
        return x
    return _GatherRows.apply(x, tuple(axes), mesh)


class BatchShard(NamedTuple):
    """A step's batch split over the ``axes`` of ``mesh`` (contiguous
    rows in block order): what a layer that computes over the whole batch
    (``layers.moe.moe_apply``'s groups) is handed with this rank's rows."""

    mesh: object
    axes: tuple

    @property
    def n(self) -> int:
        """The number of batch blocks."""
        return math.prod(self.mesh.shape[a] for a in self.axes)

    @property
    def block(self) -> int:
        """This rank's block."""
        return specs_lib.block_index(self.axes, self.mesh,
                                     rank_coords(self.mesh))[1]

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every block's rows of ``x``, under autograd."""
        return gather_rows(x, self.axes, self.mesh)
