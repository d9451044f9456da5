"""Parameter declarations and their initialisation.

Port of ``repro/models/module.py``. A model declares its parameters once
as a nested dict of ``ParamDecl``: shape, *logical axis names* (``"embed"``,
``"ff"``, ``"heads"``, ``"experts"``, ``"vocab"``, ...), init rule, scale and
type. ``init_params`` materialises the tree from an explicit
``torch.Generator``; ``sharding.specs.param_specs`` resolves the axes to
mesh axes; the dry-run (``launch.dryrun``) builds shapes from the same
declarations. The draws cannot equal JAX's threefry draws, but
each tensor's standard deviation is ``_materialize``'s
(``repro/models/module.py:58``): ``fan_in`` rules divide by the square
root of the product of every dimension but the last, and for stacked
layer parameters that product includes the stacking dimension (e.g.
``layers/attn/wq`` ``[24, 2560, 32, 80]`` has fan_in 24 * 2560 * 32).
That keeps activations at the JAX model's scale. The other rules copy
JAX's too: "zeros", "ones" (which ignores ``scale``: xLSTM's ``b_f``
declares 2.0 and is 1) and "normal" (``scale`` is the std, with no
fan-in).
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["ParamDecl", "map_decls", "stacked", "init_std", "init_params",
           "torch_dtype"]


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    """One array: its shape, the logical axis name (or None) of each dim,
    its init rule ("fan_in", "zeros", "ones" or "normal"), scale and type
    (a numpy-style name, ``"float32"`` for every parameter)."""

    shape: tuple
    axes: tuple
    init: str = "fan_in"
    scale: float = 1.0
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} with axes {self.axes}")


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32, "bool": torch.bool}


def torch_dtype(name: str) -> torch.dtype:
    """A declaration's type name as a ``torch.dtype``."""
    return _DTYPES[name]


def _leaves(tree, prefix=""):
    """(path, decl) pairs in sorted-key order, as ``jax.tree`` flattens."""
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _leaves(value, path + "/")
        else:
            yield path, value


def map_decls(fn, tree):
    """``fn`` of every declaration of a tree of dicts, tuples and lists
    (``None`` stays ``None``), in the tree's shape."""
    if isinstance(tree, dict):
        return {k: map_decls(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_decls(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def stacked(decl_tree, n: int, axis_name: str = "layers"):
    """Prepend a stacking dim of ``n`` (logical axis ``axis_name``) to
    every declaration."""
    return map_decls(
        lambda d: dataclasses.replace(d, shape=(n,) + tuple(d.shape),
                                      axes=(axis_name,) + tuple(d.axes)),
        decl_tree)


def init_std(d: ParamDecl) -> float:
    """Standard deviation of a "fan_in" or "normal" init
    (``module.py:62-71``)."""
    if d.init == "normal":
        return d.scale
    if d.init != "fan_in":
        raise ValueError(f"no random init: {d.init}")
    fan_in = math.prod(d.shape[:-1]) if len(d.shape) > 1 else d.shape[0]
    return d.scale / math.sqrt(max(fan_in, 1))


def materialize(d: ParamDecl, generator: torch.Generator, device):
    """One declaration's tensor (drawn in f32, then cast to its type)."""
    if d.init in ("zeros", "ones"):
        fill = torch.zeros if d.init == "zeros" else torch.ones
        return fill(d.shape, dtype=torch_dtype(d.dtype), device=device)
    t = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return t.mul_(init_std(d)).to(torch_dtype(d.dtype))


def init_params(decl_tree, generator: torch.Generator, device=None):
    """Materialise a declaration tree (nested dicts of tensors, same keys),
    drawing leaves in sorted-key order from ``generator`` on its device."""
    device = generator.device if device is None else torch.device(device)
    out: dict = {}
    for path, decl in _leaves(decl_tree):
        *parents, name = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = materialize(decl, generator, device)
    return out
