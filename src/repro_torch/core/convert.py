"""Carry state across the JAX package and this one.

The recommender has no model weights: its trained state is its
parameters. These helpers move that state as a flat mapping of numpy arrays keyed by
the JAX ``DisgdState`` / ``DicsState`` / ``Tables`` field names — what
``jax.tree.map(np.asarray, result.final_states)`` gives, flattened with
``flatten_state``. The container is picked by its fields: a ``co`` leaf
means DICS. Shapes carry over unchanged (one worker, or stacked
``[n_c, ...]``). The JAX DICS state's ``co_scale`` is ``None`` in compute
form and is skipped.

For the LM zoo, ``params_from_numpy`` builds the port's model from the
JAX parameter pytree mapped to numpy (layers stacked ``[L, ...]``), and
``caches_from_numpy`` / ``caches_to_numpy`` move a dense model's decode
cache (the JAX ``caches[1]``, ``{"k", "v", "pos", "length"}`` stacked
over layers) both ways, so a JAX prefill can feed the port's decode.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.state import DicsState, DisgdState, Tables
from repro_torch.models.layers.attention import KVCache
from repro_torch.models.transformer import Transformer

__all__ = ["flatten_state", "states_from_numpy", "states_to_numpy",
           "params_from_numpy", "caches_from_numpy", "caches_to_numpy"]

_DTYPES = {"user_vecs": torch.float32, "item_vecs": torch.float32,
           "co": torch.float32, "item_cnt": torch.float32,
           "rated": torch.bool}
_HEAVY = {DisgdState: ("user_vecs", "item_vecs", "rated"),
          DicsState: ("co", "item_cnt", "rated")}


def _container(fields) -> type:
    return DicsState if "co" in fields else DisgdState


def flatten_state(state) -> dict:
    """Any ``DisgdState``- or ``DicsState``-shaped tuple (this package's,
    or the JAX package's mapped to numpy) -> ``{field name: leaf}``."""
    heavy = _HEAVY[_container(state._fields)]
    return {**state.tables._asdict(),
            **{name: getattr(state, name) for name in heavy}}


def states_from_numpy(mapping: Mapping[str, np.ndarray], device="cuda"):
    """Build this package's ``DisgdState`` or ``DicsState`` from numpy
    leaves."""
    def leaf(name):
        dtype = _DTYPES.get(name, torch.int32)
        return torch.tensor(np.asarray(mapping[name]), dtype=dtype,
                            device=device)

    cls = _container(mapping)
    return cls(Tables(*(leaf(f) for f in Tables._fields)),
               *(leaf(name) for name in _HEAVY[cls]))


def states_to_numpy(state) -> dict:
    """The reverse: ``{field name: numpy array}`` on the host (copies,
    never views of the live tensors)."""
    return {name: t.detach().to("cpu", copy=True).numpy()
            for name, t in flatten_state(state).items()}


def params_from_numpy(tree: Mapping, cfg, device="cuda"):
    """The JAX parameter pytree as nested dicts of numpy arrays -> the
    port's ``Transformer`` on ``device`` (f32, the JAX layouts)."""
    def leaf(x):
        if isinstance(x, Mapping):
            return {k: leaf(v) for k, v in x.items()}
        return torch.tensor(np.asarray(x, dtype=np.float32), device=device)

    return Transformer(leaf(tree), cfg)


_CACHE_DTYPES = {"k": torch.bfloat16, "v": torch.bfloat16,
                 "pos": torch.int32, "length": torch.int32}


def caches_from_numpy(tree: Mapping, device="cuda"):
    """The stacked part of a JAX dense decode cache (``caches[1]``: ``k``,
    ``v``, ``pos``, ``length`` as numpy arrays, ``k``/``v`` any float
    type) -> the port's stacked ``KVCache``."""
    return KVCache(**{
        f: torch.tensor(np.asarray(tree[f], dtype=np.float32
                                   if f in ("k", "v") else np.int32),
                        device=device).to(dtype)
        for f, dtype in _CACHE_DTYPES.items()})


def caches_to_numpy(caches) -> dict:
    """The port's stacked ``KVCache`` -> ``{"k", "v", "pos", "length"}``
    numpy arrays on the host (``k``/``v`` as float32)."""
    out = {}
    for f in _CACHE_DTYPES:
        t = getattr(caches, f).detach().to("cpu", copy=True)
        out[f] = (t.float() if t.is_floating_point() else t).numpy()
    return out
