"""Carry worker state across the JAX package and this one.

The system has no model weights: its trained state is its parameters.
These helpers move that state as a flat mapping of numpy arrays keyed by
the JAX ``DisgdState`` / ``DicsState`` / ``Tables`` field names — what
``jax.tree.map(np.asarray, result.final_states)`` gives, flattened with
``flatten_state``. The container is picked by its fields: a ``co`` leaf
means DICS. Shapes carry over unchanged (one worker, or stacked
``[n_c, ...]``). The JAX DICS state's ``co_scale`` is ``None`` in compute
form and is skipped.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.state import DicsState, DisgdState, Tables

__all__ = ["flatten_state", "states_from_numpy", "states_to_numpy"]

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
