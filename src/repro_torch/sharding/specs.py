"""Logical-axis -> mesh-axis resolution (port of ``repro/sharding/specs.py``).

One rule table describes the whole zoo; per-array divisibility is checked
against the mesh, so hymba's 25 attention heads fall back to replicated
heads while its 5,504-wide FFN still shards, and dbrx's 8 KV heads stay
replicated on a 16-wide model axis while its 16 experts shard.

The rules, ``data_axes``, ``resolve_spec`` and ``param_specs`` are
JAX's, over the port's layout ``launch.mesh.Mesh``, and
give the port's own :class:`PartitionSpec`: one entry per dim, ``None``,
an axis name or a tuple of names. JAX hands a spec to GSPMD
(``shardings``); here a rank holds the block of each array that its mesh
coordinates select (:func:`local_shape`, :func:`shard_slices`), and
``sharding.fsdp`` moves the blocks.

Coordinates: rank ``r`` of a mesh sits at ``r`` unravelled row-major over
``mesh.axis_names`` (``jax.make_mesh``'s order on a host); a dim sharded
over several axes is split major to minor in the entry's order.
"""

from __future__ import annotations

import math

from repro_torch.models.module import map_decls

__all__ = [
    "PARAM_RULES",
    "ACT_RULES",
    "PartitionSpec",
    "data_axes",
    "resolve_spec",
    "param_specs",
    "entry_axes",
    "spec_axes",
    "coords_of",
    "block_index",
    "local_shape",
    "shard_slices",
]

# Logical axis -> candidate mesh axes, in priority order. First candidate
# whose size divides the dim wins; otherwise the dim is replicated.
PARAM_RULES: dict[str, tuple] = {
    "vocab": ("model",),
    "ff": ("model",),
    "experts": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "inner": ("model",),      # SSM / xLSTM expanded inner dim
    "embed": ("fsdp",),       # resolved to the data (+pod) axes
    "layers": (),
    "head_dim": (),
    "state": (),
    "conv": (),
}

ACT_RULES: dict[str, tuple] = {
    "batch": ("dp",),         # resolved to (pod, data) / (data,)
    "vocab": ("model",),
    "ff": ("model",),
    "experts": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "inner": ("model",),
    "seq": (),
    "cache_seq": ("model",),  # seq-sharded decode caches (kv-head fallback)
    "embed": (),
    "head_dim": (),
    "state": (),
    "groups": ("dp",),        # MoE dispatch groups
}


class PartitionSpec(tuple):
    """A partition spec: one entry per dim, ``None`` (replicated), a mesh
    axis name, or a tuple of names (split over their product)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def data_axes(mesh) -> tuple:
    """The batch/FSDP axes: ("pod", "data") on the multi-pod mesh."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _resolve_axis(logical, dim, mesh, rules, overrides=None, used=()):
    if logical is None:
        return None
    table = dict(rules)
    if overrides:
        table.update(overrides)
    for cand in table.get(logical, ()):
        if cand == "fsdp" or cand == "dp":
            axes = data_axes(mesh)
            size = math.prod(mesh.shape[a] for a in axes)
            if axes and dim % size == 0 and not (set(axes) & set(used)):
                return axes if len(axes) > 1 else axes[0]
        elif isinstance(cand, tuple):
            # Multi-axis candidate: shard this dim over all listed axes.
            if all(a in mesh.shape for a in cand):
                size = math.prod(mesh.shape[a] for a in cand)
                if dim % size == 0 and not (set(cand) & set(used)):
                    return cand if len(cand) > 1 else cand[0]
        elif cand in mesh.shape and dim % mesh.shape[cand] == 0 \
                and cand not in used:
            return cand
    return None


def resolve_spec(axes, shape, mesh, rules=ACT_RULES,
                 overrides=None) -> PartitionSpec:
    """PartitionSpec for one array from its logical axes.

    A mesh axis is assigned to at most one dim (first come, first served:
    earlier dims win, later dims fall back to replication).
    """
    out, used = [], []
    for a, d in zip(axes, shape):
        r = _resolve_axis(a, d, mesh, rules, overrides, used=tuple(used))
        out.append(r)
        used.extend(entry_axes(r))
    return PartitionSpec(*out)


def param_specs(decl_tree, mesh, overrides=None):
    """PartitionSpec tree matching a ParamDecl tree."""
    return map_decls(
        lambda d: resolve_spec(d.axes, d.shape, mesh, PARAM_RULES, overrides),
        decl_tree,
    )


def entry_axes(entry) -> tuple:
    """The mesh axes one spec entry names, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_axes(spec) -> tuple:
    """Every mesh axis a spec names."""
    return tuple(a for e in spec for a in entry_axes(e))


def coords_of(mesh, rank: int) -> dict:
    """Rank ``rank``'s coordinate on each axis (row-major)."""
    out, r = {}, rank
    for a in reversed(mesh.axis_names):
        out[a] = r % mesh.shape[a]
        r //= mesh.shape[a]
    return {a: out[a] for a in mesh.axis_names}


def block_index(entry, mesh, coords) -> tuple[int, int]:
    """(number of blocks, this rank's block) of a dim under ``entry``."""
    n, i = 1, 0
    for a in entry_axes(entry):
        n, i = n * mesh.shape[a], i * mesh.shape[a] + coords[a]
    return n, i


def local_shape(spec, shape, mesh) -> tuple:
    """The shape of one rank's block of an array of ``shape``."""
    out = []
    for e, d in zip(spec, shape):
        n = block_index(e, mesh, {a: 0 for a in mesh.axis_names})[0]
        if d % n:
            raise ValueError(f"dim {d} does not split over {e} ({n})")
        out.append(d // n)
    return tuple(out) + tuple(shape[len(spec):])


def shard_slices(spec, shape, mesh, coords) -> tuple:
    """The index of the block at ``coords`` (per axis) in an array of
    ``shape``: one ``slice`` a dim."""
    out = []
    for e, d in zip(spec, shape):
        n, i = block_index(e, mesh, coords)
        out.append(slice(i * (d // n), (i + 1) * (d // n)))
    return tuple(out)
