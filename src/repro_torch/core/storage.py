"""Memory accounting of worker states.

Port of ``repro/core/storage.py:296-323`` and ``gather_rated`` (:215)
only: ``table_arrays``, ``state_nbytes``, ``total_nbytes`` and
``gather_rated`` for the identity policy (every table in its compute
dtype), which is the only one the port runs. The rest of the module —
``StoragePolicy``, bit packing, quantized and bf16 tables, the codecs —
comes with ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

import torch

from repro_torch.core.state import DicsState, DisgdState

__all__ = ["table_arrays", "state_nbytes", "total_nbytes", "gather_rated"]


def table_arrays(states) -> dict[str, torch.Tensor]:
    """Named tables of a (single or stacked) worker state."""
    out = dict(states.tables._asdict())
    if isinstance(states, DisgdState):
        out.update(user_vecs=states.user_vecs, item_vecs=states.item_vecs,
                   rated=states.rated)
    elif isinstance(states, DicsState):
        out.update(co=states.co, item_cnt=states.item_cnt,
                   rated=states.rated)
    else:
        raise TypeError(f"unknown state type {type(states)}")
    return out


def state_nbytes(states) -> dict[str, tuple[str, int]]:
    """Exact resident bytes per table: ``{table: (dtype, nbytes)}``, the
    dtype named as numpy names it (``"int32"``, ``"float32"``, ``"bool"``),
    from tensor metadata only (no device sync)."""
    return {name: (str(t.dtype).removeprefix("torch."),
                   t.numel() * t.element_size())
            for name, t in table_arrays(states).items()}


def total_nbytes(states) -> int:
    """Total resident bytes of a worker state."""
    return sum(n for _, n in state_nbytes(states).values())


def gather_rated(rated: torch.Tensor, slots: torch.Tensor, policy=None,
                 i_cap: int | None = None) -> torch.Tensor:
    """The ``rated`` rows of a batch of user slots of every worker:
    stacked ``rated[W, U, I]`` with ``slots[W, B]`` -> ``[W, B, I]``.
    Identity policy only (``policy`` None): the rows are already in
    their compute form."""
    if policy is not None:
        raise ValueError("storage policies are not ported yet; they come "
                         "with the storage slice (ROADMAP Queue 1 item 11)")
    w = torch.arange(rated.shape[0], device=rated.device)[:, None]
    return rated[w, slots.long()]
