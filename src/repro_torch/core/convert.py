"""Carry DISGD worker state across the JAX package and this one.

The system has no model weights: its trained state is its parameters.
These helpers move that state as a flat mapping of numpy arrays keyed by
the JAX ``DisgdState`` / ``Tables`` field names — what
``jax.tree.map(np.asarray, result.final_states)`` gives, flattened with
``flatten_state``. Shapes carry over unchanged (one worker, or stacked
``[n_c, ...]``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.state import DisgdState, Tables

__all__ = ["flatten_state", "states_from_numpy", "states_to_numpy"]

_DTYPES = {"user_vecs": torch.float32, "item_vecs": torch.float32,
           "rated": torch.bool}


def flatten_state(state) -> dict:
    """Any ``DisgdState``-shaped tuple (this package's, or the JAX
    package's mapped to numpy) -> ``{field name: leaf}``."""
    return {**state.tables._asdict(), "user_vecs": state.user_vecs,
            "item_vecs": state.item_vecs, "rated": state.rated}


def states_from_numpy(mapping: Mapping[str, np.ndarray],
                      device="cuda") -> DisgdState:
    """Build this package's ``DisgdState`` from numpy leaves."""
    def leaf(name):
        dtype = _DTYPES.get(name, torch.int32)
        return torch.tensor(np.asarray(mapping[name]), dtype=dtype,
                            device=device)

    return DisgdState(tables=Tables(*(leaf(f) for f in Tables._fields)),
                      user_vecs=leaf("user_vecs"),
                      item_vecs=leaf("item_vecs"), rated=leaf("rated"))


def states_to_numpy(state: DisgdState) -> dict:
    """The reverse: ``{field name: numpy array}`` on the host (copies,
    never views of the live tensors)."""
    return {name: t.detach().to("cpu", copy=True).numpy()
            for name, t in flatten_state(state).items()}
